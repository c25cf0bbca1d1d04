"""Drive jaxstream_torch's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

Sixteen paths at C384, halo 2, float32, PLR + MC, and the other
reconstructions' paths, through the port's entry points
(``CovariantShallowWater`` and ``ShallowWater``, ``make_fused_step`` and
``make_step``, the steppers and the step-budget bisection of
``jaxstream_torch.experiments``, and ``setup_sharding`` with
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
  second phase, and the torch band);
* TC5 on the compact stepper and the kernel-backed classic path in each
  reconstruction besides PLR-MC (PLR with the limiters ``none``,
  ``minmod``, ``mc_sign``, ``vanleer`` at halo 2; PPM at halo 3), each
  launching its mode's instance of the stage and RHS kernels; and the
  Galewsky jet with PPM at halo 3 on the split del^4 stepper;
* the config-driven run (``jaxstream_torch.simulation.Simulation`` and
  ``python -m jaxstream_torch run``): TC5 on the compact and Cartesian
  steppers, the Galewsky jet from ``examples/configs/galewsky_c384.yaml``
  (split del^4) with its resume from a checkpoint, and TC5 on the face
  tier, each segmented by its history and checkpoint strides;
* TC5 on the Cartesian model's three paths (in-kernel, concat, classic
  ``backend='pallas'``) and on the covariant extended-carry stepper in
  each reconstruction besides PLR-MC, each launching its mode's instance
  of ``csrc/swe_stage_inkernel.cu``, ``swe_stage.cu``, ``swe_rhs.cu`` and
  ``cov_stage_inkernel.cu``; and a ``Simulation`` of Cartesian TC5 with
  PPM at halo 3;
* queue A items 1 and 2 through ``Simulation``: the in-loop telemetry,
  its guards, sink and flight recorder and the async host pipeline on
  the compact TC5 path, the split Galewsky jet, the B = 16 ensemble and
  the face tier, and the lazy grid (phases 67-74);
* the ensemble, precision and carry knobs of the compact path: TC5
  ensembles of 4 and 16 members on the batched fused stepper (one launch
  of ``csrc/cov_stage_members.cu`` per stage for all members), TC5 and
  the Galewsky jet (split and re-fused) under the bf16 stage policy
  (``cov_stage_policy_bf16.cu``, ``cov_nu4_filter_bf16.cu``,
  ``cov_stage_refused_nu4_policy_bf16.cu``), the mixed16 and bf16 carry
  encodings, ``temporal_block``, ``Simulation`` with ``ensemble:`` and
  ``precision:`` blocks, the split filter every second step, and every
  other policy instance (``cov_stage_refused_nu4_policy.cu``,
  ``cov_stage_inkernel_bf16.cu``).

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
8. the Galewsky jet to day 6 (8 640 steps) on the split stepper through
   ``Simulation`` (``examples/configs/galewsky_c384.yaml``, its io off,
   telemetry every 60 steps: phase 70), gated as
   ``bench.py::bench_galewsky`` gates it (finite, 8500 < h < 10800 m,
   mass drift < 1e-3, 5e-5 < max|zeta| north of 0.2 rad < 5e-4,
   max|zeta| south of -0.2 rad < 5e-6), with the filter launches checked
   against the steps and the stage launches against 3 x steps;
9. a timed window of 500 split steps, its breakdown (4 routes, 3 stage
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
12. the jet to day 1 on the re-fused stepper under the same gate, with
    the launches checked (re-fused 1 440, stage 2 880), then a timed
    window of 500 steps, its breakdown (3 routes, 1 re-fused launch,
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
18. a timed window of 500 extended steps with the launches checked
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
21. the main path: 20 + 500 in-kernel steps of TC5 gated, the launches
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
24. 20 + 500 neighbour-read steps of TC5 gated, the launches checked
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
26. 20 + 500 whole steps of TC5 gated, the launches checked against
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
32. each tier path's main run: 5 + 50 steps gated as phase 4, the
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
35. the bisection's main path, ``nu4_bisect.run`` at 500 iterations:
    each chain's wall and device microseconds per iteration, its
    launches checked against its windows (the in-stage pair's and
    B14's counters), and B14's time per mode against its bound and
    beside its earlier design's (``EARLIER_DEVICE_US``);
36. the port's ``utils.profiling`` on the compact TC5 stepper:
    ``steady_state_rate`` over 200- and 1 000-step windows with the
    ``Roofline`` report of ``analytic_cov_step_cost(384)``, a
    ``StepTimer`` p50, and ``integrate_with_metrics`` over 200 steps with
    total mass and total energy every 20 steps, its carry bitwise
    ``integrate``'s;
37. (after phase 33) for each reconstruction besides PLR-MC, its path:
    three compact steps against three steps of the kernel-backed classic
    path (``backend='pallas'``, <= 2e-4 of max), then 20 compact steps
    (PPM: 20 + 500, timed, gated as phase 4), the launches of the
    mode's stage (B1) and RHS (B4) instances checked;
38. B1 in that mode as stages 1-3 and as stage 3 with y0 = -2 yc, and B4
    over six faces, against their plain versions on the TC5 state and on
    the stepped carry (bitwise required), and their times;
39. (PPM) the step's device time as a CUDA graph and the halo-3 route;
40. the Galewsky jet with PPM at halo 3 (dt = 60 s, nu4 = 1e14, split):
    the filter kernel (B2) bitwise against its plain version at halo 3
    on the carry after one step, with its probe; three split steps
    against three classic del^4 steps (<= 2e-3 of max, mass <= 1e-5);
    500 timed steps, finite, mass drift < 1e-3, the launches checked,
    and B2 bitwise and timed on that carry;
41. ``Simulation`` of TC5 as a config dict (covariant, ``backend:
    pallas``, dt = 75 s, 1 000 steps, history and checkpoints every 500
    into a directory of ``build/``): the compact stepper taken, B1's
    launches 3 000, the TC5 gate, the history frames and checkpoint
    steps, and the final state bitwise equal to ``make_fused_step(75)``
    driven by ``integrate`` with the same segmentation (``compact_state``
    / ``restrict_state`` at each 500-step boundary); then the time of
    one C384 history snapshot and of one checkpoint save;
42. ``examples/configs/galewsky_c384.yaml`` read by the port's loader,
    its io block alone moved (strides 720), ``run(nsteps=1440)``: the
    split stepper, B1 4 320 and B2 1 440 launches, finite, bitwise equal
    to the split stepper with the same segmentation;
43. a second ``Simulation`` on a copy of phase 42's step-720 checkpoint
    resumes there and reaches phase 42's final state bitwise (B1 2 160,
    B2 720 launches);
44. ``Simulation`` of Cartesian TC5 (``backend: pallas``, 1 000 steps):
    the extended in-kernel stepper, B11 3 000 launches, the TC5 gate,
    bitwise equal to its stepper with the same segmentation;
45. TC5 with ``use_shard_map: true, num_devices: 6`` (the face tier on
    six virtual ranks), 20 steps, against the single-device classic
    path (<= 2e-4 of max), B4's stacked launches 60;
46. ``python -m jaxstream_torch run <TC5 C384 yaml> --nsteps 200`` as a
    subprocess: its JSON line's ``steps``, ``t_seconds`` and
    ``diagnostics`` equal to an in-process run's;
47. ``Simulation.run`` (segments, history, checkpoints) against the bare
    stepper under ``integrate`` in turns, for phase 41's configuration;
48. for each reconstruction besides PLR-MC, Cartesian TC5 on the
    in-kernel stepper in that mode (its B11 instance): 20 steps (PPM at
    halo 3: 20 + 500, timed and gated as phase 4), the launches
    checked;
49. its concat (B10) and classic ``backend='pallas'`` (B9) paths: 3
    steps of each and of the in-kernel stepper against 3 classic
    ``backend='jnp'`` steps (<= 2e-4 of max), in-kernel against concat
    (<= 1e-6), the launches checked; B11 and B10 as stages 1-3 and as
    stage 3 with y0 = -2 yc, and B9, bitwise against their plain
    versions on the TC5 carry and on the stepped one, and their times;
50. TC5 on the covariant extended-carry stepper in that mode (its B8
    instance): 3 steps against 3 compact steps (<= 1e-6), B8 as stages
    1-3 and the probe bitwise on the TC5 carry and after the 3 steps,
    and its times;
51. (PPM) the in-kernel and concat steps' device time as CUDA graphs and
    the halo-3 strip router;
52. ``Simulation`` of Cartesian TC5 with PPM at halo 3 (``backend:
    pallas``, 200 steps, history and checkpoints every 100): the
    in-kernel stepper in mode PPM, B11 600 launches, the TC5 gate,
    bitwise equal to its stepper with the same segmentation;
53. for each reconstruction besides PLR-MC, TC5 on the router-free
    steppers in that mode (B13's and B12's instances): 3 nbr steps
    against 3 classic ``backend='jnp'`` steps (<= 2e-4 of max) and 3 mega
    steps against 3 compact ones (<= 1e-6), then 20 steps of each (PPM
    at halo 3: 20 + 500, timed and gated as phase 4), the launches
    checked;
54. B13 as stages 1-3 and as stage 3 with y0 = -2 yc, and B12, bitwise
    against their plain versions on the TC5 carry and on the stepped
    one, their times, and B12's blocks per SM and grid;
55. the Galewsky jet in that mode (dt = 60 s, nu4 = 1e14): 3 re-fused
    (B3) and 3 in-stage (B7 A and B) steps against 3 split steps (<= 2e-3
    of max, mass <= 1e-5), the in-stage ones against 3 classic del^4
    steps (<= 5e-4); PPM: day 1 on the re-fused stepper under
    ``bench_galewsky``'s gate and 500 timed in-stage steps; the launches
    checked;
56. B3 (at nu4 and at a probe's) and A (stages 1-3) bitwise against
    their plain versions on the initial carry and the stepped ones, and
    their times;
57. ``examples/configs/galewsky_c384.yaml`` changed in code to PPM, halo
    3 and ``nu4_mode: refused`` (io every 720), ``run(nsteps=1440)``: the
    re-fused PPM stepper, B3 1 440 and B1 2 880 launches, bitwise equal
    to its stepper with the same segmentation;
58. TC5 with ``perturbed_ensemble`` members on the batched fused stepper
    (``make_fused_step(ensemble=B)``: one launch of B1's float32 ensemble
    instance, ``csrc/cov_stage_members.cu``, per stage over the 6 B folded
    faces,
    one batched route): at B = 4 and B = 16 the batched launch bitwise
    against its plain version; at B = 4 each member after 3 steps bitwise
    its single-member run on cov_stage.cu's stepper;
59. B = 16: 20 + 500 steps, every member under TC5's gate, the launches
    checked, member-steps/s, the step's device time as a CUDA graph, the
    idle share, the peak memory, the batched route against one member's,
    the instance's times at B = 16 and B = 4;
60. compact TC5 at ``precision='bf16'`` (B1's bf16 instance,
    ``cov_stage_policy_bf16.cu``): bitwise on the TC5 carry and after 20 +
    500 gated steps, the distance from the f32 path; the Galewsky jet
    at bf16: B2 with bf16 strips (filter and probe) and B3's bf16 instance
    bitwise, 3 split and re-fused bf16 steps against 3 f32 split steps;
61. the re-fused bf16 jet to day 6 (the launches, B3 bitwise at day 6
    and timed), and last the split bf16 jet to day 6 (the launches, B2
    bitwise at day 6 and timed), each under ``bench_galewsky``'s gate with
    the bf16 bound on the resting south, max|ζ| < 1e-5 (the f32 gate's
    5e-6 is missed by the bf16 policy's rounding in the JAX package's jet
    too: PERF.md, ``scripts/torch_precision_probe.py galewsky6``);
62. the mixed16 (int16 h in 1/16 m about the mid-range, bf16 u) and bf16
    TC5 carries: B1's policy instance bitwise on the encoded carry, 500
    steps, TC5's gate on the decoded h (mass drift < 1e-3; for the bf16
    carry the lesser of the band ``bench.py`` documents for its leak,
    3e-2, and twice that leak's rate over the run), the times;
63. the compact step at ``temporal_block=4`` bitwise 4 single steps;
64. ``Simulation`` of TC5 with ``ensemble.members: 4`` and
    ``precision.stage: bf16``, and with ``precision.carry: mixed16`` (200
    steps, io every 100): the launches, TC5's gate, each bitwise equal to
    its stepper under ``integrate`` with the same segmentation;
65. the split filter at ``interval = 2`` (every second step, twice the
    coefficient): 20 steps bitwise equal to the compact step and the
    filter by hand, the launches checked; then towards day 6 in chunks,
    the first non-finite chunk reported (at nu4 = 1e14 twice the
    coefficient is past the explicit filter's stability limit, in the JAX
    package too, PERF.md); then at nu4 = 5e13, where the filter of two
    steps is the single-step filter of nu4 = 1e14, to day 1 under the
    Galewsky gate;
66. every other policy instance on 3 steps of its own stepper, bitwise
    against its plain version on the carry it reached, and timed: B1 and
    B3 (TC5 orography, nu4 = 1e14, re-fused) under the bf16 policy in
    each PLR limiter besides MC and under bf16 strips alone in each mode
    (PPM at halo 3), B8 under bf16 compute in each PLR limiter, and B1's
    float32 ensemble instance (two members) in each mode besides PLR-MC;
67. ``Simulation`` of TC5 (compact, B1) in three modes, in that order:
    io off, sync (history and checkpoints every 100 steps, telemetry
    every 10 with a sink, guards ``checkpoint_and_raise``, a flight dir)
    and async (the same with ``io.async_pipeline``), each 100 + 1 000
    steps (the warm-up one io stride, so the timed boundaries fall on the
    strides): TC5's gate, the final states bitwise equal, the history
    store byte-equal, the checkpoints restored bitwise and the sink
    records equal (timing masked) between sync and async; steps/s, each
    mode's ``host_wait_s`` from its sink, the io overhead; one 100-step
    metric segment under ``torch.cuda.set_sync_debug_mode("error")``; the
    final h regridded by ``viz.plots.to_latlon`` on the device, bitwise
    its numpy form;
68. one metric sample's device time (CUDA events over 200 calls, and as
    a CUDA graph), host time and kernel launches; the stream's last sample
    equal to ``metric_fn`` on the final state, its mass drift against
    ``utils.diagnostics`` (<= 2e-6); steps/s with metrics on and off in
    turns, the states bitwise equal;
69. a stream fault on a sampled step: HealthError with the last good
    step, the guard record in the sink before the ``flight`` and ``crash``
    records, the postmortem checkpoint, the committed flight bundle read
    by ``read_bundle`` and by ``scripts/postmortem.py``; a new
    ``Simulation`` on the same directories resumes with its lineage and
    ends bitwise equal to the uninterrupted run;
70. (on phase 8's run) the covariant ladder with enstrophy, the sink's
    mass drift against the gate's (<= 2e-6), the guard events CFL breaches
    only (the jet's CFL number in the ladder's convention passes the
    default limit of 2 at dt = 60 s; policy ``warn``);
71. the TC5 ensemble at B = 16 (B1's member fold) with telemetry: a
    non-finite row per member, the spread in the sink, member-steps/s
    with metrics on and off in turns, every member under TC5's gate;
72. the face tier (B4 stacked, six virtual ranks) with telemetry: its
    samples against the single-device run's (mass <= 2e-6, the rest
    <= 2e-4, the float32 tier budgets);
73. ``grid.metrics: lazy``: compact TC5 against eager in turns (the
    gate, the distance, steps/s), and the classic path's ms per step;
74. the flight recorder on against ``flight.disabled()``, paired windows
    in alternating order, the quietest ratio's overhead;
75. the serving stack (``jaxstream_torch.serve``): a grouped TC5
    ``EnsembleServer`` at C384 (dt = 75 s, segments of 8 steps, buckets 1
    and 16: B1 and B1's member fold), one segment of each bucket under
    ``torch.cuda.set_sync_debug_mode("error")``; bench_serving's ragged
    ladder (48 requests, lengths 24, 43, 17, 56, 37) packed (cap 16),
    serial (cap 1) and on the static B = 16 ensemble stepper for the same
    member-steps, in turns (packed, static, serial, static, packed):
    every request ok, the member-steps, every
    request bitwise packed vs serial, three bitwise their solo runs, a
    B = 1 request bitwise ``Simulation``, ``compile_count`` unchanged
    after warm-up; member-steps/s, packed / static, occupancy,
    utilization, latency p50/p99, ``host_wait_s`` and host microseconds
    per boundary; the buckets' masked segments against the bare
    steppers in turns, and one request's state build;
76. a mixed-orography batch (tc2, tc5, tc6, galewsky) on B4 through the
    ``vmap_b`` bucket: one batch, each result bitwise its baked-static
    solo run, B4 bitwise its plain version with a per-member orography
    (the mountain and zeros), one segment under sync debug ``error``;
    B4 launches per member-step and the member-step wall;
77. guards: ``fault_member`` under ``evict`` (the rest of the batch
    bitwise its solo runs) and under ``halt`` (the popped refill back at
    the queue head, the crash bundle's open requests);
78. the stdlib ``Gateway`` over phase 75's deployment with tracing, both
    sinks and an ``AutoscaleController`` over (1, 4, 16), driven by
    ``run_load`` with bench_serving_slo's trace (seed 1404, mean gap
    0.02 s, tail alpha 1.4, lengths 16, 25, 8, 43; 32 requests): every
    request ok or typed-shed, span coverage 1.0, the metrics scrape
    parsed, no build after warm-up, WebSocket == HTTP == a direct
    submission bitwise, a ``POST /v1/profile`` capture holding
    ``serve.segment`` and the stage kernels; goodput / phase 75's packed
    rate, p50/p99, the resizes;
79. the serving warm pool (``serve.warm_pool``): phase 75's deployment
    with buckets 1, 4 and 16, server A cold on an empty pool (its
    buckets' warm-up seconds, three entries saved), three ladder
    requests; server B in a child process whose kernel-library
    directory starts empty, from the pool: 0 nvcc builds, 0 table
    builds, ``compile_count`` 0, each bucket's warm-up seconds, the three
    results' sha256 equal to A's; one byte of an entry's payload flipped:
    one ``corrupt`` record, a rebuild, the same sha256; a changed
    ``time.dt`` misses;
80. the tiers in every reconstruction besides PLR-MC (PLR none, minmod,
    mc_sign, vanleer at halo 2, PPM at halo 3): the face tier and the
    (6, 2, 2) block tier, serialized and overlapped, 3 steps against the
    classic path (<= 2e-4 of max, mass < 2e-6), PPM then 5 + 50 steps
    gated as phase 32 with steps/s, the launches counted around the
    paths; B4's stacked instance, B5's and B6's bitwise against their
    plain versions at the IC and on the run's state, their device
    times, bounds and shares;
81. face-tier del^4: the Galewsky jet (nu4 = 1e14 m^4/s, dt = 60 s) on
    the face tier, serialized and overlapped, 3 steps against the
    classic del^4 path (<= 5e-4 of max), then 5 + 50 steps gated
    (finite, 8500 < h < 10800 m, mass < 2e-6) with steps/s.

It prints a JSON line of the kernels, the card's name and power limit,
and last ``{"ok": true, "device": {...}}``.  Exits non-zero, with no
result, without a CUDA device or without the rest of the repository.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch

STEP_DT = 75.0
N = 384
WARM_STEPS = 20
# The timed windows (500 since the warm pool's and the tiers' modes'
# phases joined: the script must finish in its time limit on a slow host).
TIMED_STEPS = 500
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
# SASS instructions (cuobjdump -sass) of the PLR-MC kernel functions, in
# ptxas's order, of the libraries that carry one instance per
# reconstruction, as the tree before each took its modes built them with
# nvcc of CUDA 12.8 (scripts/torch_sass_counts.py on an NVIDIA H100 80GB
# HBM3; cov_stage_nu4: kernel B's NoLap, NoFill and Full, then A): the
# log says whether each still builds to the same code.
EARLIER_SASS = {"cov_stage": [5624], "cov_rhs": [3472],
                "cov_stage_inkernel": [6608], "swe_rhs": [4920],
                "swe_stage": [5424, 4616],
                "swe_stage_inkernel": [8488, 7984],
                "cov_stage_refused_nu4": [8904],
                "cov_stage_nu4": [3832, 2848, 5064, 6264],
                "cov_step_mega": [6632], "cov_stage_nbr": [7040],
                "cov_rhs_interior": [3256], "cov_rhs_local": [3520]}
# The tendency alone is ill-conditioned in float32 (its flux differences
# cancel): two f32 evaluations differ by ~1e-5 of its max.
TENDENCY_TOL = 1e-4
FUSED_VS_CLASSIC_TOL = 2e-4
# Galewsky: bench.py::bench_galewsky's configuration and day-6 run.
GAL_DT = 60.0
GAL_NU4 = 1.0e14
GAL_DAY6_STEPS = 8640
# The runs that day 6 of another stepper already covers (the re-fused MC
# and PPM jets, the split filter every second step) go to day 1, under
# the same gate.
GAL_DAY1_STEPS = 1440
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
TIER_TIMED_STEPS = 50
TIER_PROFILED_STEPS = 3
# The step-budget bisection (jaxstream_torch.experiments.nu4_bisect):
# its two windows are BISECT_ITERS / 4 and BISECT_ITERS iterations.
BISECT_ITERS = 250
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
# Phases 37-40: the reconstructions besides PLR-MC, as (scheme, limiter);
# PPM runs at halo 3 (its face states read three cells each side), the
# PLR limiters at halo 2.  Each mode's kernels are checked on the TC5
# state and after RECON_WARM_STEPS steps of its own compact stepper.
RECON_MODES = {"none": ("plr", "none"), "minmod": ("plr", "minmod"),
               "mc_sign": ("plr", "mc_sign"), "vanleer": ("plr", "vanleer"),
               "ppm": ("ppm", "mc")}
RECON_WARM_STEPS = 20
# The C functions' mangled names of the mode instances (cov_stage.cu,
# cov_rhs.cu, cov_rhs_interior.cu, cov_rhs_local.cu,
# cov_stage_inkernel.cu, cov_stage_refused_nu4.cu, cov_stage_nu4.cu's
# kernel A, cov_step_mega.cu, cov_stage_nbr.cu, swe_rhs.cu, swe_stage.cu,
# swe_stage_inkernel.cu): the kernel's stem and the mode.  The ptxas lines of EARLIER_PTXAS are the other functions.
# The kernel of a policy library's mangled function name.
POLICY_KERNEL = re.compile(r"\d(cov_[a-z0-9_]*kernel[a-z_]*)E")
MODE_KERNEL = re.compile(
    r"\d([a-z][a-z_]*(?:nu4[a-z_]*)?)_kernel_"
    r"(none|minmod|mc_sign|vanleer|ppm)E")


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


def sass_counts(lib) -> dict:
    """SASS instructions per kernel function of the built library
    ``lib`` (``cuobjdump -sass``, beside nvcc)."""
    from pathlib import Path

    from jaxstream_torch import _build

    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], check=True,
                         capture_output=True, text=True).stdout
    counts = {}
    for sec in re.split(r"\n\s*Function : ", out)[1:]:
        name = sec.split("\n", 1)[0].strip()
        counts[name] = len(re.findall(r"/\*[0-9a-f]{4,}\*/\s+\S", sec))
    return counts


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
    averaged over the forms); ``device_ms`` is the device time per launch
    as a CUDA graph beside ``ms``'s CUDA events."""
    mean = lambda k: sum(t[k] for t in timed) / len(timed)
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": mean(0),
        "device_ms": mean(4),
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


def tc5_gate(label: str, grid, s0, h_int, days: float,
             mass_tol: float = 1e-3) -> None:
    """``bench.py::bench_tc5``'s gate on the interior height ``h_int``:
    finite, 3000 < h < 6500 m, mass drift from ``s0`` < ``mass_tol``
    (its default 1e-3; its one documented wider band is the bf16 carry's,
    ``BF16_CARRY_MASS_TOL``)."""
    from jaxstream_torch.utils.diagnostics import total_mass

    h = h_int.double()
    area = grid.interior(grid.area).double()
    mass0 = float(torch.sum(area * s0["h"].double()))
    drift = abs(float(torch.sum(area * h)) - mass0) / mass0
    finite = bool(torch.isfinite(h).all())
    hmin, hmax = float(h.min()), float(h.max())
    gate = finite and 3000.0 < hmin and hmax < 6500.0 and drift < mass_tol
    log(f"gate C{N} TC5 ({label}) after {days:.2f} d: finite={finite} "
        f"h_range=[{hmin:.1f}, {hmax:.1f}] (in (3000, 6500)) "
        f"mass_drift={drift:.3e} (<{mass_tol:g}) total_mass="
        f"{float(total_mass(grid, h_int)):.6e} -> "
        f"{'passed' if gate else 'FAILED'}")
    if not gate:
        raise RuntimeError(f"TC5 gate failed ({label})")


class Galewsky:
    """The C384 Galewsky configuration: grid, model (nu4 = 1e14), initial
    state and carry, and its day-6 gate; ``halo`` and ``scheme`` as the
    model takes them (PPM needs halo 3)."""

    def __init__(self, halo: int = 2, scheme: str = "plr",
                 limiter: str = "mc"):
        from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                            EARTH_RADIUS)
        from jaxstream_torch.geometry.cubed_sphere import build_grid
        from jaxstream_torch.models.shallow_water_cov import (
            CovariantShallowWater)
        from jaxstream_torch.physics.initial_conditions import galewsky

        t0 = time.perf_counter()
        self.grid = build_grid(N, halo=halo, radius=EARTH_RADIUS,
                               dtype=torch.float32)
        h_ext, v_ext = galewsky(self.grid, EARTH_GRAVITY, EARTH_OMEGA)
        self.model = CovariantShallowWater(self.grid, gravity=EARTH_GRAVITY,
                                           omega=EARTH_OMEGA, nu4=GAL_NU4,
                                           scheme=scheme, limiter=limiter)
        self.s0 = self.model.initial_state(h_ext, v_ext)
        self.y0 = self.model.compact_state(self.s0)
        self.area = self.grid.interior(self.grid.area).double()
        self.mass0 = float(torch.sum(self.area * self.s0["h"].double()))
        torch.cuda.synchronize()
        log(f"setup: C{N} grid (halo {halo}), Galewsky, model (nu4 "
            f"{GAL_NU4:g}, {scheme}, {limiter}) in "
            f"{time.perf_counter() - t0:.2f} s on {self.grid.device}")

    def drift(self, h) -> float:
        return abs(float(torch.sum(self.area * h.double())) - self.mass0) \
            / self.mass0

    def gate(self, label: str, y, t: float, extra: str,
             s_limit: float = 5e-6) -> None:
        """``bench_galewsky``'s day-6 gate on the carry ``y``; ``s_limit``
        bounds max|zeta| in the resting south (the bf16 policy's own,
        GAL_BF16_S_LIMIT, is wider)."""
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
              and 5e-5 < z_n < 5e-4 and z_s < s_limit)
        log(f"gate Galewsky C{N} nu4 ({label}) day {t / 86400.0:g}: "
            f"finite={finite} h_range=[{hmin:.1f}, {hmax:.1f}] (in (8500, "
            f"10800)) mass_drift={drift:.3e} (<1e-3) max|zeta| N={z_n:.3e} "
            f"(in (5e-5, 5e-4)) S={z_s:.3e} (<{s_limit:g}); {extra} -> "
            + ("passed" if ok else "FAILED"))
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

    # ---- 8. main path: the jet to day 6 through Simulation, gated as
    # bench_galewsky, with telemetry (phase 70's checks) ------------------
    launches, y, t = galewsky_day6_simulation(card, gal)

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

    # ---- 12. main path: day 1 on the re-fused stepper, timed window -------
    Stage.launches = 0
    Refused.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(step, y0, 0.0, GAL_DAY1_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall6 = time.perf_counter() - t0
    launches = (Refused.launches, Stage.launches)
    if launches != (GAL_DAY1_STEPS, 2 * GAL_DAY1_STEPS):
        raise RuntimeError(f"launches (re-fused, stage) {launches} != "
                           f"(1 x, 2 x) {GAL_DAY1_STEPS} steps")
    gal.gate("re-fused", y, t,
             f"launches re-fused {launches[0]} = {GAL_DAY1_STEPS}, stage "
             f"{launches[1]} = 2 x {GAL_DAY1_STEPS}; {GAL_DAY1_STEPS} steps "
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
        f"re-fused kernel vs plain C{N}, day 1 + {TIMED_STEPS} steps", st1f,
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

    # ---- 21. main path: 20 + 500 in-kernel steps, launches, gate --------
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

    # ---- 24. main path: 20 + 500 nbr steps, launches, gate --------------
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

    # ---- 26. main path: 20 + 500 mega steps, launches, gate -------------
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


def recon_mode_path(card: str, mode: str) -> list:
    """Phases 37-39 for one reconstruction: TC5 at C384 in ``mode``
    (halo 3 for PPM).  Its path first: the compact stepper (20 steps; for
    PPM 20 + 500, timed and gated) and 3 steps of the kernel-backed
    classic path (``backend='pallas'``) against 3 fused steps, the
    launches counted around it; then B1 (stages 1-3, stage 3 with y0 =
    -2 yc) and B4 (six faces) bitwise against their plain versions on the
    TC5 state and on the stepped carry, and timed there.  Returns the two
    kernels' records for the kernels line."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    Stage, Rhs = swe_cov.CovStageCompact, swe_cov.CovRhs
    scheme, limiter = RECON_MODES[mode]
    halo = 3 if scheme == "ppm" else 2
    t0 = time.perf_counter()
    grid = build_grid(N, halo=halo, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext,
                                  scheme=scheme, limiter=limiter,
                                  backend="pallas")
    step = model.make_fused_step(STEP_DT)
    s0 = model.initial_state(h_ext, v_ext)
    y0 = model.compact_state(s0)
    route, stages, kern = step.route, step.stages, model._pallas_rhs.kernel
    if [st.mode for st in stages] + [kern.mode] != [mode] * 4:
        raise RuntimeError(f"{mode}: the stepper's kernels are not in mode "
                           f"{mode}")
    torch.cuda.synchronize()
    log(f"setup: C{N} grid (halo {halo}), TC5, {mode} model and steppers in "
        f"{time.perf_counter() - t0:.2f} s")

    # ---- the mode's path: its launches counted around it ----------------
    Stage.launches = Rhs.launches = 0
    yf, _ = integrate(step, y0, 0.0, 3, STEP_DT)
    yc, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    errs = {k: rel_err(yc[k], yf[k]) for k in ("h", "u")}
    log(f"{mode} fused vs kernel-backed classic C{N}, 3 steps: max rel diff "
        f"h {errs['h']:.3e}, u {errs['u']:.3e} (tol "
        f"{FUSED_VS_CLASSIC_TOL:g})")
    if max(errs.values()) > FUSED_VS_CLASSIC_TOL:
        raise RuntimeError(f"{mode}: fused step disagrees with the classic "
                           "path")
    del yf, yc
    y, t = integrate(step, y0, 0.0, RECON_WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    nsteps = 3 + RECON_WARM_STEPS
    if mode == "ppm":
        t_w = time.perf_counter()
        y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_w
        nsteps += TIMED_STEPS
        steps_s = TIMED_STEPS / wall
        log(f"main path C{N} TC5 PPM (halo 3) dt={STEP_DT:g}: "
            f"{TIMED_STEPS} steps in {wall:.3f} s -> {steps_s:.1f} steps/s, "
            f"{1e6 / steps_s:.1f} us/step, "
            f"{steps_s * STEP_DT / 86400.0:.3f} sim-days/s; card {card}")
        tc5_gate("compact, PPM", grid, s0, y["h"], t / 86400.0)
    launches = (Stage.launches, Rhs.launches)
    if launches != (3 * nsteps, 9):
        raise RuntimeError(f"{mode}: launches (B1, B4) {launches} != "
                           f"(3 x {nsteps}, 3 x 3)")
    if not bool(torch.isfinite(y["h"]).all()):
        raise RuntimeError(f"{mode}: carry not finite")
    log(f"{mode} path: {nsteps} fused steps, 3 classic; launches B1 "
        f"{launches[0]} = 3 x {nsteps}, B4 {launches[1]} = 3 x 3")

    # ---- 37-38. B1 and B4 vs plain on the TC5 state and the carry -------
    names = ("h", "u", "strips_sn", "strips_we")
    st1, st2, st3 = stages
    max_b1 = max_b4 = 0.0
    forms = []
    for label, c in (("TC5 state", y0), (f"after {nsteps} steps", y)):
        hc, uc = c["h"], c["u"]
        gsn, gwe = route(c["strips_sn"], c["strips_we"])
        a1 = (hc, uc, gsn, gwe, model.b_ext)
        a2 = (hc, uc, hc, uc, gsn, gwe, model.b_ext)
        a3 = (-2.0 * hc, -2.0 * uc, hc, uc, gsn, gwe, model.b_ext)
        for sl, st, a, tol in (("stage 1", st1, a1, KERNEL_TOL),
                               ("stage 2", st2, a2, KERNEL_TOL),
                               ("stage 3", st3, a2, KERNEL_TOL),
                               ("stage 3, y0=-2yc", st3, a3, TENDENCY_TOL)):
            max_b1 = max(max_b1, check_kernel(
                f"B1 {mode} vs plain C{N} {sl}, {label}", st, st.reference,
                a, names, tol, lambda: Stage.launches, exact=True))
        he, ue = model.fill(hc), model._fill_u(uc)
        args = (kern.fz[:, None], he, ue, model.b_ext) \
            + model._pallas_rhs.sym(ue)
        max_b4 = max(max_b4, check_kernel(
            f"B4 {mode} vs plain C{N} (six faces), {label}", kern,
            kern.reference, args, ("dh", "du"), TENDENCY_TOL,
            lambda: Rhs.launches, exact=True))
        forms = ((a1, a2), args)
    (a1, a2), args = forms
    b1 = record(f"cov_stage_compact {mode}",
                "jaxstream_torch/csrc/cov_stage.cu",
                "jaxstream/ops/pallas/swe_cov.py:1989", launches[0], max_b1,
                [time_form(f"B1 {mode} {sl}", st, st.reference, a,
                           FLOPS_PER_CELL, card)
                 for sl, st, a in (("stage 1", st1, a1), ("stage 2", st2, a2),
                                   ("stage 3", st3, a2))])
    b4 = record(f"cov_rhs {mode}", "jaxstream_torch/csrc/cov_rhs.cu",
                "jaxstream/ops/pallas/swe_cov.py:508", launches[1], max_b4,
                [time_form(f"B4 {mode} six faces", kern, kern.reference,
                           args, FLOPS_PER_CELL, card)])
    if mode == "ppm":
        r_ms = event_ms(lambda: route(y["strips_sn"], y["strips_we"]), 200)
        log(f"PPM TC5 step: device {step_device_us(step, y, t, STEP_DT):.2f}"
            f" us/step as a CUDA graph of {GRAPH_STEPS} steps; B1 "
            f"{b1['ms'] * 1e3:.2f} us/launch (events), router (halo 3) "
            f"{r_ms * 1e3:.2f} us/call; card {card}")
    return [b1, b4]


def ppm_galewsky_path(card: str) -> dict:
    """Phase 40: the Galewsky jet with PPM at halo 3 on the split del^4
    stepper (dt = 60 s, nu4 = 1e14): B2 bitwise against its plain version
    at halo 3 on the carry after one split step, with its probe; 3 split
    steps against 3 classic del^4 steps (<= 2e-3 of max, mass <= 1e-5);
    then 500 timed steps (finite, mass drift < 1e-3) with the launches
    checked, and B2's times there.  Returns B2's halo-3 record."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Stage, Filter = swe_cov.CovStageCompact, swe_cov.CovNu4Filter
    gal = Galewsky(halo=3, scheme="ppm")
    grid, model, s0, y0 = gal.grid, gal.model, gal.s0, gal.y0
    step = model.make_fused_step(GAL_DT)
    route, filt = step.route, step.filter
    y1 = step(y0, 0.0)
    args = (y1["h"], y1["u"]) + route(y1["strips_sn"], y1["strips_we"])
    exact = filt.reference(*[a.double() for a in args])
    scale, _ = probe_scale((args[0], args[1][0], args[1][1]),
                           (exact[0], exact[1][0], exact[1][1]))
    probe = swe_cov.make_cov_nu4_filter(grid, GAL_NU4 * scale, filt.dt_eff)
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: Filter.launches
    max_abs = max(
        check_kernel(f"B2 halo 3 vs plain C{N} (gsn {tuple(args[2].shape)})",
                     filt, filt.reference, args, names, KERNEL_TOL, count,
                     exact=True),
        check_kernel(f"B2 halo 3 vs plain C{N} probe (filter term alone)",
                     probe, probe.reference, args, names, PROBE_TOL, count,
                     exact=True))
    ysplit, _ = integrate(step, y0, 0.0, 3, GAL_DT)
    yc, _ = integrate(model.make_step(GAL_DT), s0, 0.0, 3, GAL_DT)
    gal.compare("PPM split vs classic del^4", yc, ysplit,
                SPLIT_VS_CLASSIC_TOL, DAMP_SCALE_MASS_TOL)
    del yc, ysplit
    Stage.launches = Filter.launches = 0
    y, t, step_us = timed_window("Galewsky nu4 (split, PPM, halo 3)", step,
                                 y0, 0.0, TIMED_STEPS, card)
    launches = (Stage.launches, Filter.launches)
    drift = gal.drift(y["h"])
    log(f"PPM Galewsky after {TIMED_STEPS} steps: launches (B1 ppm, B2) "
        f"{launches}; mass drift {drift:.3e} (<1e-3)")
    if launches != (3 * TIMED_STEPS, TIMED_STEPS) or not drift < 1e-3:
        raise RuntimeError("PPM Galewsky: launches or mass drift")
    fargs = (y["h"], y["u"]) + route(y["strips_sn"], y["strips_we"])
    max_abs = max(max_abs, check_kernel(
        f"B2 halo 3 vs plain C{N}, after {TIMED_STEPS} steps", filt,
        filt.reference, fargs, names, KERNEL_TOL, count, exact=True))
    timed = [time_form("B2 halo 3", filt, filt.reference, fargs,
                       FILTER_FLOPS_PER_CELL, card)]
    log(f"PPM Galewsky step: device {step_device_us(step, y, t, GAL_DT):.2f}"
        f" us/step as a CUDA graph of {GRAPH_STEPS} steps; card {card}")
    return record("cov_nu4_filter halo3",
                  "jaxstream_torch/csrc/cov_nu4_filter.cu",
                  "jaxstream/ops/pallas/swe_cov.py:2544", launches[1],
                  max_abs, timed)


def recon_paths(card: str, t_start: float) -> list:
    """Phases 37-40: every reconstruction besides PLR-MC (see
    :func:`recon_mode_path`), then the PPM Galewsky path."""
    records = []
    for mode in RECON_MODES:
        stamp(t_start, f"reconstruction {mode} (phases 37-39)")
        records += recon_mode_path(card, mode)
    stamp(t_start, "Galewsky PPM, halo 3 (phase 40)")
    records.append(ppm_galewsky_path(card))
    return records


# Phases 41-47: the config-driven run (jaxstream_torch.simulation).
SIM_TC5_STEPS = 1000
SIM_TC5_STRIDE = 500
SIM_GAL_CONFIG = "examples/configs/galewsky_c384.yaml"
SIM_GAL_STEPS = 1440
SIM_GAL_STRIDE = 720
SIM_FACE_STEPS = 20
SIM_CLI_STEPS = 200
# Phase 47's turns (sim, bare, bare, sim): one set, so that phases 58-66
# fit the script's time (two sets left the comparison as unresolved).
SIM_TURN_REPS = 1


def sim_tc5_config(root: str, tag: str, **model) -> dict:
    """TC5 at C384 as a config dict: ``tag`` picks the io paths under
    ``root``; history and checkpoint strides of SIM_TC5_STRIDE."""
    import os

    return {
        "grid": {"n": N, "halo": 2, "dtype": "float32"},
        "model": {"name": "shallow_water_cov", "initial_condition": "tc5",
                  "scheme": "plr", "limiter": "mc", "backend": "pallas",
                  **model},
        "physics": {"hyperdiffusion": 0.0},
        "time": {"dt": STEP_DT, "nsteps": SIM_TC5_STEPS},
        "parallelization": {"num_devices": 1, "device_type": "gpu"},
        "io": {"history_path": os.path.join(root, tag, "hist"),
               "history_stride": SIM_TC5_STRIDE,
               "checkpoint_path": os.path.join(root, tag, "ckpt"),
               "checkpoint_stride": SIM_TC5_STRIDE},
    }


def with_io(cfg, root: str, name: str, stride: int):
    """A loaded Config with only its io block moved under ``root``."""
    import dataclasses
    import os

    return dataclasses.replace(cfg, io=dataclasses.replace(
        cfg.io, history_path=os.path.join(root, name, "hist"),
        history_stride=stride,
        checkpoint_path=os.path.join(root, name, "ckpt"),
        checkpoint_stride=stride))


def segmented(model, step, prep, s0, dt: float, nsteps: int, seg: int):
    """``step`` driven by ``integrate`` as Simulation segments it:
    ``prep`` -> ``seg`` steps -> ``restrict_state`` per segment."""
    from jaxstream_torch.stepping import integrate

    s, t = s0, 0.0
    for _ in range(nsteps // seg):
        y, t = integrate(step, prep(s), t, seg, dt)
        s, t = model.restrict_state(y), float(t)
    return s, t


def hold_bitwise(label: str, sim, ref: dict, t_ref: float,
                 against: str = "the stepper driven by integrate with the "
                 "same segmentation") -> None:
    bad = [k for k in ref if not torch.equal(ref[k], sim.state[k])]
    log(f"{label}: Simulation state vs {against}: "
        + ("bitwise equal" if not bad else f"DIFFERS in {bad}")
        + f"; t {sim.t:g} vs {t_ref:g}")
    if bad or sim.t != t_ref:
        raise RuntimeError(f"{label}: Simulation differs from its stepper")


def check_io(label: str, sim, nsteps: int, stride: int, start: int = 0):
    """The run's history frames and checkpoint steps."""
    want = list(range(start, nsteps + 1, stride))
    frames = len(sim.history)
    steps = sim.checkpoints.steps()
    log(f"{label}: history {frames} frames at t = "
        f"{[float(x) for x in sim.history.times]}; checkpoints at steps "
        f"{steps}")
    if frames != len(range(0, nsteps + 1, stride)) or steps != [
            s for s in want if s > 0]:
        raise RuntimeError(f"{label}: history or checkpoints missing")


def sim_turns(label: str, make_sim, bare, nsteps: int, card: str) -> None:
    """``Simulation.run`` (segments, history, checkpoints) against the
    bare stepper under ``integrate``, in turns sim, bare, bare, sim,
    SIM_TURN_REPS times; the host's speed drifts within a call, so only
    windows taken in turns compare."""
    rates = {"sim": [], "bare": []}
    waits = []
    for _ in range(SIM_TURN_REPS):
        for name in ("sim", "bare", "bare", "sim"):
            if name == "sim":
                sim = make_sim()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sim.run(nsteps)
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                bare()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rates[name].append(nsteps / wall)
            if name == "sim":
                waits.append(sim.host_wait / wall)
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"{label}: Simulation.run vs bare integrate, {nsteps} steps per "
        f"window in turns (sim, bare, bare, sim) x {SIM_TURN_REPS}: sim "
        + ", ".join(f"{r:.1f}" for r in rates["sim"]) + " steps/s; bare "
        + ", ".join(f"{r:.1f}" for r in rates["bare"]) + " steps/s; "
        f"mean {mean['sim']:.1f} vs {mean['bare']:.1f}, sim/bare "
        f"{mean['sim'] / mean['bare']:.4f}; history and checkpoint writes "
        + ", ".join(f"{w:.2%}" for w in waits)
        + f" of each sim window's wall; card {card}")


def simulation_paths(card: str, t_start: float) -> None:
    """Phases 41-47: ``Simulation`` on the card at C384 (see the module
    docstring), its io in a directory of the checkout's ``build/``."""
    import os
    import shutil
    import tempfile

    from jaxstream_torch.config import load_config
    from jaxstream_torch.io.checkpoint import CheckpointManager
    from jaxstream_torch.io.history import HistoryWriter
    from jaxstream_torch.ops.cuda.swe_cov import (CovNu4Filter, CovRhs,
                                                  CovStageCompact)
    from jaxstream_torch.ops.cuda.swe_step import SweStageInkernel
    from jaxstream_torch.simulation import Simulation
    from jaxstream_torch.stepping import integrate

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_sim_",
                            dir=os.path.join(here, "build"))
    try:
        # ---- 41. TC5 on the compact stepper through Simulation ----------
        stamp(t_start, "Simulation: TC5 compact (phase 41)")
        sim = Simulation(sim_tc5_config(root, "tc5"))
        if sim.stepper_kind != "compact":
            raise RuntimeError(f"TC5 took the {sim.stepper_kind} stepper")
        s0 = {k: v.clone() for k, v in sim.state.items()}
        CovStageCompact.launches = 0
        t0 = time.perf_counter()
        sim.run()
        wall = time.perf_counter() - t0
        launches = CovStageCompact.launches
        log(f"Simulation TC5 C{N} compact: {SIM_TC5_STEPS} steps in "
            f"{wall:.3f} s ({SIM_TC5_STEPS / wall:.1f} steps/s with history "
            f"and checkpoints every {SIM_TC5_STRIDE}); B1 launches "
            f"{launches} (want {3 * SIM_TC5_STEPS}); card {card}")
        if launches != 3 * SIM_TC5_STEPS:
            raise RuntimeError("Simulation TC5: B1 launch count")
        tc5_gate("Simulation compact", sim.grid, s0, sim.state["h"],
                 SIM_TC5_STEPS * STEP_DT / 86400.0)
        check_io("Simulation TC5", sim, SIM_TC5_STEPS, SIM_TC5_STRIDE)
        m = sim.model
        step = m.make_fused_step(STEP_DT)
        ref, t_ref = segmented(m, step, m.compact_state, s0, STEP_DT,
                               SIM_TC5_STEPS, SIM_TC5_STRIDE)
        hold_bitwise("Simulation TC5", sim, ref, t_ref)
        diag = sim.diagnostics()
        log(f"Simulation TC5 diagnostics: {diag}")
        # The cost of one C384 history snapshot and one checkpoint.
        hw = HistoryWriter(os.path.join(root, "snap"))
        ck = CheckpointManager(os.path.join(root, "snap_ckpt"))
        snap, save = [], []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hw.append(sim.state, float(i))
            snap.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ck.save(i, sim.state, float(i))
            save.append(time.perf_counter() - t0)
        mb = sum(v.numel() * v.element_size()
                 for v in sim.state.values()) / 1e6
        log(f"C{N} state {mb:.2f} MB: history snapshot (to the host and "
            f"to disk) " + ", ".join(f"{x * 1e3:.2f}" for x in snap)
            + " ms; checkpoint save " + ", ".join(f"{x * 1e3:.2f}"
                                                  for x in save)
            + f" ms; card {card}")
        tc5 = {"s0": s0, "step": step, "model": m}
        del sim, ref

        # ---- 42. Galewsky from its config file ---------------------------
        stamp(t_start, "Simulation: Galewsky from its config (phase 42)")
        gal_cfg = with_io(load_config(os.path.join(here, SIM_GAL_CONFIG)),
                          root, "gal", SIM_GAL_STRIDE)
        sim = Simulation(gal_cfg)
        if sim.stepper_kind != "compact" or sim.model.nu4 != 1.0e14:
            raise RuntimeError("Galewsky config: not the split stepper")
        g0 = {k: v.clone() for k, v in sim.state.items()}
        CovStageCompact.launches = CovNu4Filter.launches = 0
        t0 = time.perf_counter()
        sim.run(nsteps=SIM_GAL_STEPS)
        wall = time.perf_counter() - t0
        b1, b2 = CovStageCompact.launches, CovNu4Filter.launches
        log(f"Simulation Galewsky C{N} ({SIM_GAL_CONFIG}, io strides "
            f"{SIM_GAL_STRIDE}): {SIM_GAL_STEPS} steps in {wall:.3f} s "
            f"({SIM_GAL_STEPS / wall:.1f} steps/s); B1 launches {b1} (want "
            f"{3 * SIM_GAL_STEPS}), B2 launches {b2} (want "
            f"{SIM_GAL_STEPS}); card {card}")
        if (b1, b2) != (3 * SIM_GAL_STEPS, SIM_GAL_STEPS):
            raise RuntimeError("Simulation Galewsky: launch counts")
        if not all(bool(torch.isfinite(v).all()) for v in
                   sim.state.values()):
            raise RuntimeError("Simulation Galewsky: state not finite")
        check_io("Simulation Galewsky", sim, SIM_GAL_STEPS, SIM_GAL_STRIDE)
        gm = sim.model
        gstep = gm.make_fused_step(gal_cfg.time.dt)
        gref, gt = segmented(gm, gstep, gm.compact_state, g0,
                             gal_cfg.time.dt, SIM_GAL_STEPS, SIM_GAL_STRIDE)
        hold_bitwise("Simulation Galewsky", sim, gref, gt)
        gal_final = {k: v.clone() for k, v in sim.state.items()}
        del sim, gref

        # ---- 43. resume at the midpoint ----------------------------------
        stamp(t_start, "Simulation: resume (phase 43)")
        res_cfg = with_io(gal_cfg, root, "gal_resume", SIM_GAL_STRIDE)
        shutil.copytree(os.path.join(root, "gal", "ckpt",
                                     str(SIM_GAL_STRIDE)),
                        os.path.join(res_cfg.io.checkpoint_path,
                                     str(SIM_GAL_STRIDE)))
        sim = Simulation(res_cfg)
        if sim.step_count != SIM_GAL_STRIDE:
            raise RuntimeError(f"resume: at step {sim.step_count}")
        CovStageCompact.launches = CovNu4Filter.launches = 0
        sim.run(nsteps=SIM_GAL_STEPS)
        b1, b2 = CovStageCompact.launches, CovNu4Filter.launches
        steps = SIM_GAL_STEPS - SIM_GAL_STRIDE
        log(f"resumed Galewsky at step {SIM_GAL_STRIDE}: ran {steps} steps, "
            f"B1 launches {b1}, B2 launches {b2}")
        if (b1, b2) != (3 * steps, steps):
            raise RuntimeError("resume: launch counts")
        hold_bitwise("resumed Galewsky", sim, gal_final, gt,
                     "the uninterrupted run")
        del sim, gal_final

        # ---- 44. Cartesian TC5 -------------------------------------------
        stamp(t_start, "Simulation: Cartesian TC5 (phase 44)")
        sim = Simulation(sim_tc5_config(root, "cart", name="auto"))
        if sim.stepper_kind != "extended":
            raise RuntimeError(f"Cartesian TC5 took the {sim.stepper_kind}"
                               " stepper")
        c0 = {k: v.clone() for k, v in sim.state.items()}
        SweStageInkernel.launches = 0
        sim.run()
        launches = SweStageInkernel.launches
        log(f"Simulation Cartesian TC5 C{N}: {SIM_TC5_STEPS} steps, B11 "
            f"launches {launches} (want {3 * SIM_TC5_STEPS})")
        if launches != 3 * SIM_TC5_STEPS:
            raise RuntimeError("Simulation Cartesian TC5: B11 launch count")
        tc5_gate("Simulation Cartesian", sim.grid, c0, sim.state["h"],
                 SIM_TC5_STEPS * STEP_DT / 86400.0)
        cm = sim.model
        cref, ct = segmented(cm, cm.make_fused_step(STEP_DT),
                             lambda s: cm.extend_state(s, with_strips=True),
                             c0, STEP_DT, SIM_TC5_STEPS, SIM_TC5_STRIDE)
        hold_bitwise("Simulation Cartesian TC5", sim, cref, ct)
        del sim, cref, c0

        # ---- 45. the face tier -------------------------------------------
        stamp(t_start, "Simulation: face tier (phase 45)")
        face_cfg = sim_tc5_config(root, "face", backend="jnp")
        face_cfg["parallelization"].update(num_devices=6,
                                           use_shard_map=True)
        face_cfg["time"]["nsteps"] = SIM_FACE_STEPS
        sim = Simulation(face_cfg)
        CovRhs.launches = 0
        sim.run()
        launches = CovRhs.launches
        cls_cfg = sim_tc5_config(root, "face_ref", backend="jnp")
        cls_cfg["time"]["nsteps"] = SIM_FACE_STEPS
        classic = Simulation(cls_cfg)
        classic.run()
        errs = {k: rel_err(classic.state[k], sim.state[k])
                for k in ("h", "u")}
        log(f"Simulation face tier (6 virtual ranks) {SIM_FACE_STEPS} "
            f"steps vs the classic path: max rel diff h {errs['h']:.3e}, "
            f"u {errs['u']:.3e} (tol {TIER_VS_CLASSIC_TOL:g}); B4 stacked "
            f"launches {launches} (want {3 * SIM_FACE_STEPS})")
        if max(errs.values()) > TIER_VS_CLASSIC_TOL \
                or launches != 3 * SIM_FACE_STEPS:
            raise RuntimeError("Simulation face tier")
        del sim, classic

        # ---- 46. the CLI ---------------------------------------------------
        stamp(t_start, "python -m jaxstream_torch run (phase 46)")
        yml = os.path.join(root, "tc5_c384.yaml")
        with open(yml, "w") as fh:
            fh.write(
                "# TC5 at C384 on the compact covariant stepper\n"
                f"grid:\n  n: {N}\n  halo: 2\n"
                "model:\n  name: shallow_water_cov\n"
                "  initial_condition: tc5\n  backend: pallas\n"
                f"time:\n  dt: {STEP_DT}\n  duration_days: 1.0\n"
                "parallelization:\n  num_devices: 1\n  device_type: gpu\n")
        out = subprocess.run(
            [sys.executable, "-m", "jaxstream_torch", "run", yml,
             "--nsteps", str(SIM_CLI_STEPS)], cwd=here, capture_output=True,
            text=True, timeout=300)
        if out.returncode != 0:
            log(out.stderr[-4000:])
            raise RuntimeError(f"python -m jaxstream_torch run: exit "
                               f"{out.returncode}")
        line = out.stdout.strip().splitlines()[-1]
        log(f"python -m jaxstream_torch run {os.path.basename(yml)} "
            f"--nsteps {SIM_CLI_STEPS}: {line}")
        rec = json.loads(line)
        inproc = Simulation(yml)
        inproc.run(SIM_CLI_STEPS)
        want = {"steps": inproc.step_count, "t_seconds": inproc.t,
                "diagnostics": inproc.diagnostics()}
        log(f"in-process run: {json.dumps(want)}")
        if rec != want:
            raise RuntimeError("the CLI's JSON differs from the in-process "
                               "run's")
        del inproc

        # ---- 47. Simulation.run against bare integrate, in turns ---------
        stamp(t_start, "Simulation.run vs integrate (phase 47)")
        k = [0]

        def fresh(cfg_of):
            """A new Simulation in a new io directory (the previous
            turn's removed: a C384 geometry store is ~130 MB)."""
            def make():
                shutil.rmtree(os.path.join(root, f"turn{k[0]}"),
                              ignore_errors=True)
                k[0] += 1
                return Simulation(cfg_of(f"turn{k[0]}"))
            return make

        s0, step, m = tc5["s0"], tc5["step"], tc5["model"]
        sim_turns(f"TC5 C{N} compact, io strides {SIM_TC5_STRIDE}",
                  fresh(lambda tag: sim_tc5_config(root, tag)),
                  lambda: integrate(step, m.compact_state(s0), 0.0,
                                    SIM_TC5_STEPS, STEP_DT),
                  SIM_TC5_STEPS, card)
    finally:
        shutil.rmtree(root, ignore_errors=True)


# Phases 48-52: every reconstruction besides PLR-MC on the Cartesian
# model's kernels (B9, B10, B11) and on the extended-carry stage (B8).
# Each mode's paths step RECON_WARM_STEPS steps (PPM: + TIMED_STEPS, timed
# and gated); the checks run on the TC5 carry and on the stepped one.
FUSED_RECON_SIM_STEPS = 200
FUSED_RECON_SIM_STRIDE = 100


def cartesian_mode_path(card: str, mode: str) -> list:
    """Phases 48-49 for one reconstruction: TC5 at C384 on the Cartesian
    ``ShallowWater`` (``backend='pallas'``) in ``mode`` (halo 3 for PPM).
    Its paths first, their launches counted around them: the in-kernel
    stepper (B11), RECON_WARM_STEPS steps (PPM: + TIMED_STEPS, timed and
    gated), 3 concat steps (B10) and 3 classic steps (B9) against 3
    classic ``backend='jnp'`` steps (<= 2e-4 of max) and in-kernel
    against concat (<= 1e-6).  Then B11 and B10 (stages 1-3 and stage 3
    with y0 = -2 yc) and B9 bitwise against their plain versions on the
    TC5 carry and on the stepped one, and their times there.  Returns
    the three kernels' records."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water import ShallowWater
    from jaxstream_torch.ops.cuda import swe_rhs, swe_step
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    Ink, Cat, Rhs = (swe_step.SweStageInkernel, swe_step.SweStage,
                     swe_rhs.SweRhs)
    scheme, limiter = RECON_MODES[mode]
    halo = 3 if scheme == "ppm" else 2
    t0 = time.perf_counter()
    grid = build_grid(N, halo=halo, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = ShallowWater(grid, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                         b_ext=b_ext, scheme=scheme, limiter=limiter,
                         backend="pallas")
    ref = ShallowWater(grid, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                       b_ext=b_ext, scheme=scheme, limiter=limiter)
    s0 = model.initial_state(h_ext, v_ext)
    step = model.make_fused_step(STEP_DT)
    step_c = model.make_fused_step(STEP_DT, in_kernel_exchange=False)
    kern, route, ex, b = model._pallas_rhs, step.route, step_c.exchange, \
        model.b_ext
    modes = [st.mode for st in step.stages + step_c.stages] + [kern.mode]
    if modes != [mode] * 7:
        raise RuntimeError(f"Cartesian {mode}: the steppers' kernels are in "
                           f"modes {modes}")
    torch.cuda.synchronize()
    log(f"setup: C{N} grid (halo {halo}), TC5, Cartesian {mode} models and "
        f"steppers in {time.perf_counter() - t0:.2f} s")

    # ---- 48-49. the mode's paths, their launches counted around them ----
    Ink.launches = Cat.launches = Rhs.launches = 0
    ye = model.extend_state(s0, with_strips=True)
    yi, _ = integrate(step, ye, 0.0, 3, STEP_DT)
    yk, _ = integrate(step_c, model.extend_state(s0), 0.0, 3, STEP_DT)
    yp, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    yj, _ = integrate(ref.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    oi, ok = model.restrict_state(yi), model.restrict_state(yk)
    errs = {k: rel_err(ok[k], oi[k]) for k in ("h", "v")}
    log(f"Cartesian {mode} in-kernel vs concat C{N}, 3 steps: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {INKERNEL_VS_CONCAT_TOL:g}); bitwise="
        + str(all(torch.equal(ok[k], oi[k]) for k in ("h", "v"))))
    bad = max(errs.values()) > INKERNEL_VS_CONCAT_TOL
    for label, o in (("in-kernel", oi), ("concat", ok),
                     ("classic pallas", yp)):
        errs = {k: rel_err(yj[k], o[k]) for k in ("h", "v")}
        log(f"Cartesian {mode} {label} vs classic jnp C{N}, 3 steps: max "
            f"rel diff h {errs['h']:.3e}, v {errs['v']:.3e} (tol "
            f"{FUSED_VS_CLASSIC_TOL:g})")
        bad = bad or max(errs.values()) > FUSED_VS_CLASSIC_TOL
    if bad:
        raise RuntimeError(f"Cartesian {mode}: the paths disagree")
    del yi, yk, yp, yj, oi, ok
    y, t = integrate(step, ye, 0.0, RECON_WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    nsteps = 3 + RECON_WARM_STEPS
    if mode == "ppm":
        t_w = time.perf_counter()
        y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_w
        nsteps += TIMED_STEPS
        steps_s = TIMED_STEPS / wall
        log(f"main path C{N} TC5 Cartesian in-kernel PPM (halo 3) "
            f"dt={STEP_DT:g}: {TIMED_STEPS} steps in {wall:.3f} s -> "
            f"{steps_s:.1f} steps/s, {1e6 / steps_s:.1f} us/step, "
            f"{steps_s * STEP_DT / 86400.0:.3f} sim-days/s; card {card}")
        tc5_gate("Cartesian in-kernel, PPM", grid, s0,
                 model.restrict_state(y)["h"], t / 86400.0)
    launches = (Ink.launches, Cat.launches, Rhs.launches)
    if launches != (3 * nsteps, 9, 9):
        raise RuntimeError(f"Cartesian {mode}: launches (B11, B10, B9) "
                           f"{launches} != (3 x {nsteps}, 3 x 3, 3 x 3)")
    if not bool(torch.isfinite(y["h"]).all()):
        raise RuntimeError(f"Cartesian {mode}: carry not finite")
    log(f"Cartesian {mode} paths: {nsteps} in-kernel steps, 3 concat, 3 "
        f"classic; launches B11 {launches[0]} = 3 x {nsteps}, B10 "
        f"{launches[1]} = 3 x 3, B9 {launches[2]} = 3 x 3")

    # ---- B11, B10 and B9 vs plain on the TC5 carry and the stepped one --
    names = ("h", "v", "sn", "we", "vsn", "vwe")
    st1, st2, st3 = step.stages
    c1, c2, c3 = step_c.stages
    max_ink = max_cat = max_rhs = 0.0
    for label, c in (("TC5 state", ye), (f"after {nsteps} steps", y)):
        g = route(c["sh_sn"], c["sh_we"], c["sv_sn"], c["sv_we"])
        a1 = (c["h"], c["v"], g, b)
        a2 = (c["h"], c["v"]) + a1
        a3 = (-2.0 * c["h"], -2.0 * c["v"]) + a1
        hx, vx = ex(c["h"]), ex(c["v"])
        b1 = (hx, vx, b)
        b2 = (hx, vx) + b1
        b3 = (-2.0 * hx, -2.0 * vx) + b1
        for sl, (st, a), (cs, bb), tol in (
                ("stage 1", (st1, a1), (c1, b1), KERNEL_TOL),
                ("stage 2", (st2, a2), (c2, b2), KERNEL_TOL),
                ("stage 3", (st3, a2), (c3, b2), KERNEL_TOL),
                ("stage 3, y0=-2yc", (st3, a3), (c3, b3), TENDENCY_TOL)):
            max_ink = max(max_ink, check_kernel(
                f"B11 {mode} vs plain C{N} {sl}, {label}", st, st.reference,
                a, names, tol, lambda: Ink.launches, exact=True))
            max_cat = max(max_cat, check_kernel(
                f"B10 {mode} vs plain C{N} {sl}, {label}", cs, cs.reference,
                bb, ("h", "v"), tol, lambda: Cat.launches, exact=True))
        max_rhs = max(max_rhs, check_kernel(
            f"B9 {mode} vs plain C{N}, {label}", kern, kern.reference, b1,
            ("dh", "dv"), TENDENCY_TOL, lambda: Rhs.launches, exact=True))
    forms = {
        "swe_stage_inkernel": (st1, st2, st3, a1, a2),
        "swe_stage": (c1, c2, c3, b1, b2)}
    records = []
    for name, (s1, s2, s3, x1, x2) in forms.items():
        kind = "in-kernel" if name == "swe_stage_inkernel" else "concat"
        timed = [time_form(f"Cartesian {kind} {mode} {sl}", st, st.reference,
                           a, SWE_STAGE_FLOPS_PER_CELL, card)
                 for sl, st, a in (("stage 1", s1, x1), ("stage 2", s2, x2),
                                   ("stage 3", s3, x2))]
        records.append(mode_record(
            name, mode, "jaxstream/ops/pallas/swe_step.py:"
            + ("424" if kind == "in-kernel" else "147"),
            launches[0 if kind == "in-kernel" else 1],
            max_ink if kind == "in-kernel" else max_cat, timed, card))
    timed = [time_form(f"Cartesian RHS {mode}", kern, kern.reference, b1,
                       SWE_RHS_FLOPS_PER_CELL, card)]
    records.append(mode_record("swe_rhs", mode,
                               "jaxstream/ops/pallas/swe_rhs.py:434",
                               launches[2], max_rhs, timed, card))
    if mode == "ppm":
        # ---- 51. the PPM steps' device time and the halo-3 router -------
        r_ms = event_ms(lambda: route(y["sh_sn"], y["sh_we"], y["sv_sn"],
                                      y["sv_we"]), 200)
        yk = model.extend_state(model.restrict_state(y))
        log(f"Cartesian PPM TC5 steps: device in-kernel "
            f"{step_device_us(step, y, t, STEP_DT):.2f}, concat "
            f"{step_device_us(step_c, yk, t, STEP_DT):.2f} us/step as CUDA "
            f"graphs of {GRAPH_STEPS} steps; strip router (halo 3) "
            f"{r_ms * 1e3:.2f} us/call; card {card}")
    return records


def mode_record(name: str, mode: str, replaces: str, launches: int,
                max_abs: float, timed, card: str) -> dict:
    """The kernels-line record of ``name``'s ``mode`` instance (source
    ``csrc/<name>.cu``), with its device time per launch as a CUDA graph
    (the mean of :func:`time_form`'s forms) logged beside its bound."""
    dev_us = sum(t[4] for t in timed) / len(timed) * 1e3
    bound_us = sum(t[2] for t in timed) / len(timed) * 1e3
    log(f"{name} {mode}: device {dev_us:.2f} us/launch as a CUDA graph, "
        f"events {sum(t[0] for t in timed) / len(timed) * 1e3:.2f}; bound "
        f"{bound_us:.2f} us, {bound_us / dev_us:.1%} of it; card {card}")
    return record(f"{name} {mode}", f"jaxstream_torch/csrc/{name}.cu",
                  replaces, launches, max_abs, timed)


def extended_mode_path(card: str, mode: str) -> dict:
    """Phase 50 for one reconstruction: TC5 at C384 on the covariant
    extended-carry stepper (``make_fused_step(compact=False)``, B8) in
    ``mode`` (halo 3 for PPM): 3 steps against 3 compact steps (<= 1e-6
    of max, bitwise predicted), the launches counted around them, then B8
    as stages 1-3 and stage 3 with y0 = -2 yc bitwise against its plain
    version on the TC5 carry and on the carry after the 3 steps, and its
    times there.  Returns its record."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageInkernel
    scheme, limiter = RECON_MODES[mode]
    halo = 3 if scheme == "ppm" else 2
    grid = build_grid(N, halo=halo, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext,
                                  scheme=scheme, limiter=limiter)
    s0 = model.initial_state(h_ext, v_ext)
    step = model.make_fused_step(STEP_DT, compact=False)
    if [st.mode for st in step.stages] != [mode] * 3:
        raise RuntimeError(f"extended {mode}: the stages are not in mode "
                           f"{mode}")
    route = step.route
    Stage.launches = 0
    ye = model.extend_state(s0, with_strips=True)
    yx, _ = integrate(step, ye, 0.0, 3, STEP_DT)
    launches = Stage.launches
    yc, _ = integrate(model.make_fused_step(STEP_DT), model.compact_state(s0),
                      0.0, 3, STEP_DT)
    out_x = model.restrict_state(yx)
    ext = model.extend_state(yc)
    pairs = {"h": (yc["h"], out_x["h"]), "u": (yc["u"], out_x["u"]),
             "strips": (swe_cov.pack_strips_cov(ext["h"], ext["u"], grid.n,
                                                grid.halo), yx["strips"])}
    errs = {k: rel_err(a, x) for k, (a, x) in pairs.items()}
    log(f"extended vs compact {mode} C{N}, 3 steps: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {EXT_VS_COMPACT_TOL:g}); bitwise="
        + str(all(torch.equal(a, x) for a, x in pairs.values()))
        + f"; B8 launches {launches} = 3 x 3")
    if max(errs.values()) > EXT_VS_COMPACT_TOL or launches != 9:
        raise RuntimeError(f"extended {mode}: disagrees with the compact "
                           "stepper, or its launches")
    del yc, ext, out_x
    names = ("h", "u", "strips")
    st1, st2, st3 = step.stages
    max_abs = 0.0
    for label, c in (("TC5 state", ye), ("after 3 steps", yx)):
        gi = route(c["strips"])
        a1 = (c["h"], c["u"], gi, model.b_ext)
        a2 = (c["h"], c["u"]) + a1
        a3 = (-2.0 * c["h"], -2.0 * c["u"]) + a1
        for sl, st, a, tol in (("stage 1", st1, a1, KERNEL_TOL),
                               ("stage 2", st2, a2, KERNEL_TOL),
                               ("stage 3", st3, a2, KERNEL_TOL),
                               ("stage 3, y0=-2yc", st3, a3, TENDENCY_TOL)):
            max_abs = max(max_abs, check_kernel(
                f"B8 {mode} vs plain C{N} {sl}, {label}", st, st.reference,
                a, names, tol, lambda: Stage.launches, exact=True))
    timed = [time_form(f"extended {mode} {sl}", st, st.reference, a,
                       FLOPS_PER_CELL, card)
             for sl, st, a in (("stage 1", st1, a1), ("stage 2", st2, a2),
                               ("stage 3", st3, a2))]
    return mode_record("cov_stage_inkernel", mode,
                       "jaxstream/ops/pallas/swe_cov.py:1243", launches,
                       max_abs, timed, card)


def cartesian_ppm_simulation(card: str) -> None:
    """Phase 52: ``Simulation`` of Cartesian TC5 with PPM at halo 3
    (``backend: pallas``, FUSED_RECON_SIM_STEPS steps, history every
    FUSED_RECON_SIM_STRIDE into a directory of ``build/``): the in-kernel
    stepper taken, B11 launched 3 x steps, the TC5 gate, and bitwise equal
    to its stepper with the same segmentation."""
    import os
    import shutil
    import tempfile

    from jaxstream_torch.ops.cuda.swe_step import SweStageInkernel
    from jaxstream_torch.simulation import Simulation

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_sim_",
                            dir=os.path.join(here, "build"))
    try:
        cfg = sim_tc5_config(root, "cart_ppm", name="auto", scheme="ppm")
        cfg["grid"]["halo"] = 3
        cfg["time"]["nsteps"] = FUSED_RECON_SIM_STEPS
        cfg["io"].update(history_stride=FUSED_RECON_SIM_STRIDE,
                         checkpoint_stride=FUSED_RECON_SIM_STRIDE)
        sim = Simulation(cfg)
        kinds = [(type(st).__name__, st.mode)
                 for st in sim._fused_step.stages]
        if (sim.stepper_kind != "extended" or sim.grid.halo != 3
                or kinds != [("SweStageInkernel", "ppm")] * 3):
            raise RuntimeError(f"Cartesian PPM config took the "
                               f"{sim.stepper_kind} stepper {kinds}")
        c0 = {k: v.clone() for k, v in sim.state.items()}
        SweStageInkernel.launches = 0
        sim.run()
        launches = SweStageInkernel.launches
        log(f"Simulation Cartesian TC5 PPM (halo 3) C{N}: "
            f"{FUSED_RECON_SIM_STEPS} steps, B11 ppm launches {launches} "
            f"(want {3 * FUSED_RECON_SIM_STEPS}); card {card}")
        if launches != 3 * FUSED_RECON_SIM_STEPS:
            raise RuntimeError("Simulation Cartesian PPM: B11 launch count")
        tc5_gate("Simulation Cartesian PPM", sim.grid, c0, sim.state["h"],
                 FUSED_RECON_SIM_STEPS * STEP_DT / 86400.0)
        check_io("Simulation Cartesian PPM", sim, FUSED_RECON_SIM_STEPS,
                 FUSED_RECON_SIM_STRIDE)
        m = sim.model
        ref, t = segmented(m, m.make_fused_step(STEP_DT),
                           lambda s: m.extend_state(s, with_strips=True),
                           c0, STEP_DT, FUSED_RECON_SIM_STEPS,
                           FUSED_RECON_SIM_STRIDE)
        hold_bitwise("Simulation Cartesian TC5 PPM", sim, ref, t)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def fused_recon_paths(card: str, t_start: float) -> list:
    """Phases 48-52: every reconstruction besides PLR-MC on B9-B11 and B8
    (see :func:`cartesian_mode_path`, :func:`extended_mode_path`), then
    the Cartesian PPM ``Simulation``.  Returns the records."""
    records = []
    for mode in RECON_MODES:
        stamp(t_start, f"Cartesian {mode} (phases 48-49)")
        records += cartesian_mode_path(card, mode)
        stamp(t_start, f"extended carry {mode} (phase 50)")
        records.append(extended_mode_path(card, mode))
    stamp(t_start, "Simulation: Cartesian TC5 PPM (phase 52)")
    cartesian_ppm_simulation(card)
    return records

# Phases 53-57: every reconstruction on B13, B12, B3 and B7 A.  The PPM
# paths run the timed and gated depth (TC5: WARM_STEPS + TIMED_STEPS on
# nbr and mega; Galewsky: day 1 on the re-fused stepper, STAGE_TIMED_STEPS
# on the in-stage one), the PLR modes RECON_WARM_STEPS TC5 steps and 3
# checked Galewsky steps.
PPM_REFUSED_SIM_STEPS = 1440
PPM_REFUSED_SIM_STRIDE = 720


def router_free_mode_path(card: str, mode: str) -> list:
    """Phases 53-54 for one reconstruction: TC5 at C384 in ``mode`` (halo
    3 for PPM) on the router-free steppers.  Their paths first, the
    launches counted around them: 3 nbr steps against 3 classic
    ``backend='jnp'`` steps (<= 2e-4 of max) and 3 mega steps against 3
    compact ones (<= 1e-6), then RECON_WARM_STEPS steps of each (PPM: +
    TIMED_STEPS, timed and gated).  Then B13 (stages 1-3, stage 3 with y0
    = -2 yc) and B12 bitwise against their plain versions on the TC5
    carry and on the stepped one, their times there, and B12's blocks per
    SM and grid.  Returns the two kernels' records."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.experiments import swe_cov_nbr, swe_mega
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    Nbr, Mega = swe_cov_nbr.CovStageNbr, swe_mega.CovMegaStep
    scheme, limiter = RECON_MODES[mode]
    halo = 3 if scheme == "ppm" else 2
    t0 = time.perf_counter()
    grid = build_grid(N, halo=halo, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext,
                                  scheme=scheme, limiter=limiter)
    s0 = model.initial_state(h_ext, v_ext)
    b = model.b_ext
    kw = {"scheme": scheme, "limiter": limiter}
    step_n = swe_cov_nbr.make_fused_ssprk3_cov_nbr(
        grid, EARTH_GRAVITY, EARTH_OMEGA, STEP_DT, b, **kw)
    step_m = swe_mega.make_fused_ssprk3_cov_mega(
        grid, EARTH_GRAVITY, EARTH_OMEGA, STEP_DT, b, **kw)
    step_c = model.make_fused_step(STEP_DT)
    kern = step_m.kernel
    modes = [st.mode for st in step_n.stages + step_c.stages] + [kern.mode]
    if modes != [mode] * 7:
        raise RuntimeError(f"router-free {mode}: the steppers' kernels are "
                           f"in modes {modes}")
    torch.cuda.synchronize()
    log(f"setup: C{N} grid (halo {halo}), TC5, {mode} model and router-free "
        f"steppers in {time.perf_counter() - t0:.2f} s")

    # ---- 53. the mode's paths, their launches counted around them -------
    ye, yc0 = model.extend_state(s0), model.compact_state(s0)
    Nbr.launches = Mega.launches = 0
    yn, _ = integrate(step_n, ye, 0.0, 3, STEP_DT)
    ym, _ = integrate(step_m, yc0, 0.0, 3, STEP_DT)
    launches3 = (Nbr.launches, Mega.launches)
    ycl, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    yc, _ = integrate(step_c, yc0, 0.0, 3, STEP_DT)
    out = model.restrict_state(yn)
    errs = {k: rel_err(ycl[k], out[k]) for k in ("h", "u")}
    log(f"nbr {mode} vs classic jnp C{N}, 3 steps: max rel diff h "
        f"{errs['h']:.3e}, u {errs['u']:.3e} (tol "
        f"{FUSED_VS_CLASSIC_TOL:g})")
    bad = max(errs.values()) > FUSED_VS_CLASSIC_TOL
    names = ("h", "u", "strips_sn", "strips_we")
    errs = {k: rel_err(yc[k], ym[k]) for k in names}
    log(f"mega {mode} vs compact C{N}, 3 steps: max rel diff "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tol {MEGA_VS_COMPACT_TOL:g}); bitwise="
        + str(all(torch.equal(yc[k], ym[k]) for k in names)))
    if bad or max(errs.values()) > MEGA_VS_COMPACT_TOL:
        raise RuntimeError(f"router-free {mode}: a stepper disagrees")
    del yn, ym, ycl, yc, out
    nsteps = RECON_WARM_STEPS + (TIMED_STEPS if mode == "ppm" else 0)
    runs = {}
    for label, step, y in (("nbr", step_n, ye), ("mega", step_m, yc0)):
        y, t = integrate(step, y, 0.0, RECON_WARM_STEPS, STEP_DT)
        torch.cuda.synchronize()
        if mode == "ppm":
            t_w = time.perf_counter()
            y, t = integrate(step, y, t, TIMED_STEPS, STEP_DT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t_w
            steps_s = TIMED_STEPS / wall
            log(f"main path C{N} TC5 {label} PPM (halo 3) dt={STEP_DT:g}: "
                f"{TIMED_STEPS} steps in {wall:.3f} s -> {steps_s:.1f} "
                f"steps/s, {1e6 / steps_s:.1f} us/step, "
                f"{steps_s * STEP_DT / 86400.0:.3f} sim-days/s; card {card}")
            hi = model.restrict_state(y)["h"] if label == "nbr" else y["h"]
            tc5_gate(f"{label}, PPM", grid, s0, hi, t / 86400.0)
        if not bool(torch.isfinite(y["h"]).all()):
            raise RuntimeError(f"{label} {mode}: carry not finite")
        runs[label] = (y, t)
    launches = (Nbr.launches, Mega.launches)
    want = (3 * (3 + nsteps), 3 + nsteps)
    log(f"router-free {mode} paths: 3 + {nsteps} steps each; launches B13 "
        f"{launches[0]} (want {want[0]}), B12 {launches[1]} (want "
        f"{want[1]}); after the 3 checked steps {launches3}")
    if launches != want:
        raise RuntimeError(f"router-free {mode}: launch counts")

    # ---- 54. B13 and B12 vs plain on the TC5 carry and the stepped one --
    st1, st2, st3 = step_n.stages
    carry = lambda y: (y["h"], y["u"], y["strips_sn"], y["strips_we"], b)
    max_n = max_m = 0.0
    for label, yx, ykc in (("TC5 state", ye, yc0),
                           (f"after {3 + nsteps} steps", runs["nbr"][0],
                            runs["mega"][0])):
        a1 = (yx["h"], yx["u"], b)
        k1 = st1.reference(*a1)
        a2 = (yx["h"], yx["u"]) + tuple(k1) + (b,)
        a3 = (-2.0 * k1[0], -2.0 * k1[1]) + tuple(k1) + (b,)
        for sl, st, a, tol in (("stage 1", st1, a1, KERNEL_TOL),
                               ("stage 2", st2, a2, KERNEL_TOL),
                               ("stage 3", st3, a2, KERNEL_TOL),
                               ("stage 3, y0=-2yc", st3, a3, TENDENCY_TOL)):
            max_n = max(max_n, check_kernel(
                f"B13 {mode} vs plain C{N} {sl}, {label}", st, st.reference,
                a, ("h", "u"), tol, lambda: Nbr.launches, exact=True))
        max_m = max(max_m, check_kernel(
            f"B12 {mode} vs plain C{N}, one step from the {label}", kern,
            kern.reference, carry(ykc), names, KERNEL_TOL,
            lambda: Mega.launches, exact=True))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    log(f"B12 {mode} grid: {kern.blocks} blocks of 256 threads on {sms} "
        f"SMs = {kern.blocks / sms:g} per SM (cooperative, all resident)")
    yx, t = runs["nbr"]
    a1 = (yx["h"], yx["u"], b)
    a2 = (yx["h"], yx["u"]) + a1
    timed = [time_form(f"B13 {mode} {sl}", st, st.reference, a,
                       FLOPS_PER_CELL, card)
             for sl, st, a in (("stage 1", st1, a1), ("stage 2", st2, a2),
                               ("stage 3", st3, a2))]
    rec_n = mode_record("cov_stage_nbr", mode,
                        "jaxstream/experiments/swe_cov_nbr.py:404",
                        launches[0], max_n, timed, card)
    ykc, t_m = runs["mega"]
    timed = [time_form(f"B12 {mode} step", kern, kern.reference, carry(ykc),
                       3 * FLOPS_PER_CELL, card)]
    rec_m = mode_record("cov_step_mega", mode,
                        "jaxstream/experiments/swe_mega.py:344", launches[1],
                        max_m, timed, card)
    if mode == "ppm":
        log(f"router-free PPM TC5 steps: device nbr "
            f"{step_device_us(step_n, yx, t, STEP_DT):.2f}, mega "
            f"{step_device_us(step_m, ykc, t_m, STEP_DT):.2f} us/step as "
            f"CUDA graphs of {GRAPH_STEPS} steps; card {card}")
    return [rec_n, rec_m]


def nu4_mode_path(card: str, mode: str) -> list:
    """Phases 55-56 for one reconstruction: the Galewsky jet at C384 in
    ``mode`` (halo 3 for PPM; dt = 60 s, nu4 = 1e14).  Its paths first,
    the launches counted around them: 3 re-fused (B3) and 3 in-stage (B7
    A and B) steps against 3 split steps (<= 2e-3 of max, mass <= 1e-5)
    and the in-stage ones against 3 classic del^4 steps (<= 5e-4); for
    PPM then day 1 on the re-fused stepper under its gate and
    STAGE_TIMED_STEPS timed in-stage steps.  Then B3 (at nu4 and at the
    probe's) and A (stages 1-3) bitwise against their plain versions on
    the initial carry and the stepped ones, and their times there.
    Returns the two kernels' records."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.stepping import integrate

    Refused, Pair = swe_cov.CovStageRefusedNu4, swe_cov.CovStageNu4
    scheme, limiter = RECON_MODES[mode]
    gal = Galewsky(halo=3 if scheme == "ppm" else 2, scheme=scheme,
                   limiter=limiter)
    grid, model, s0, y0 = gal.grid, gal.model, gal.s0, gal.y0
    split = model.make_fused_step(GAL_DT)
    refused = model.make_fused_step(GAL_DT, nu4_mode="refused")
    stage = model.make_fused_step(GAL_DT, nu4_mode="stage")
    modes = ([refused.stage1f.mode] + [st.mode for st in stage.stages]
             + [st.mode for st in refused.stages])
    if modes != [mode] * 6:
        raise RuntimeError(f"del^4 {mode}: the steppers' kernels are in "
                           f"modes {modes}")

    # ---- 55. the mode's paths, their launches counted around them -------
    Refused.launches = Pair.launches_a = Pair.launches_b = 0
    yr, _ = integrate(refused, y0, 0.0, 3, GAL_DT)
    ys, _ = integrate(stage, y0, 0.0, 3, GAL_DT)
    checked = (Refused.launches, Pair.launches_a, Pair.launches_b)
    ysplit, _ = integrate(split, y0, 0.0, 3, GAL_DT)
    ycl, _ = integrate(model.make_step(GAL_DT), s0, 0.0, 3, GAL_DT)
    gal.compare(f"re-fused {mode} vs split del^4", ysplit, yr,
                DAMP_SCALE_TOL, DAMP_SCALE_MASS_TOL)
    gal.compare(f"in-stage {mode} vs split del^4", ysplit, ys,
                DAMP_SCALE_TOL, DAMP_SCALE_MASS_TOL)
    gal.compare(f"in-stage {mode} vs classic del^4", ycl, ys,
                STAGE_VS_CLASSIC_TOL)
    del ysplit, ycl
    yrun, trun = yr, 3 * GAL_DT
    ysrun, tsrun = ys, 3 * GAL_DT
    if mode == "ppm":
        t0 = time.perf_counter()
        yrun, trun = integrate(refused, y0, 0.0, GAL_DAY1_STEPS, GAL_DT)
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t0
        gal.gate("re-fused, PPM", yrun, trun,
                 f"{GAL_DAY1_STEPS} steps in {wall6:.2f} s "
                 f"({GAL_DAY1_STEPS / wall6:.1f} steps/s)")
        ysrun, tsrun, _ = timed_window("Galewsky nu4 (in-stage, PPM, halo "
                                       "3)", stage, ys, tsrun,
                                       STAGE_TIMED_STEPS, card)
    launches = (Refused.launches, Pair.launches_a, Pair.launches_b)
    nr = 3 + (GAL_DAY1_STEPS if mode == "ppm" else 0)
    ns = 3 + (STAGE_TIMED_STEPS if mode == "ppm" else 0)
    want = (nr, 3 * ns, 3 * ns)
    log(f"del^4 {mode} paths: {nr} re-fused and {ns} in-stage steps; "
        f"launches B3 {launches[0]} (want {want[0]}), A {launches[1]}, B "
        f"{launches[2]} (want {want[1]} each); after the 3 checked steps "
        f"{checked}")
    if launches != want:
        raise RuntimeError(f"del^4 {mode}: launch counts")
    if not bool(torch.isfinite(yrun["h"]).all()):
        raise RuntimeError(f"del^4 {mode}: carry not finite")

    # ---- 56. B3 and A vs plain on the carry and the stepped ones ---------
    st1f = refused.stage1f
    names = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")
    a_names = ("h_adv", "u_adv", "l1h", "l1u", "strips_sn", "strips_we")
    route = refused.route
    max_r = max_a = 0.0
    probe = None
    for label, yb, ya in (("initial carry", y0, y0),
                          ("stepped carries", yrun, ysrun)):
        args = (yb["h"], yb["u"]) + route(yb["strips_sn"],
                                          yb["strips_we"]) + (model.b_ext,)
        if probe is None:
            exact = st1f.reference(*[a.double() for a in args])
            scale, _ = probe_scale((args[0], args[1][0], args[1][1]),
                                   (exact[2], exact[3][0], exact[3][1]))
            probe = swe_cov.make_cov_stage_refused_nu4(
                grid, model.gravity, model.omega, GAL_DT, GAL_NU4 * scale,
                scheme=scheme, limiter=limiter)
            del exact
        for st, tol, tag in ((st1f, KERNEL_TOL, ""),
                             (probe, PROBE_TOL, " probe")):
            max_r = max(max_r, check_kernel(
                f"B3 {mode} vs plain C{N}{tag}, {label}", st, st.reference,
                args, names, tol, lambda: Refused.launches, exact=True))
        a1 = (ya["h"], ya["u"]) + stage.route(
            ya["strips_sn"], ya["strips_we"]) + (model.b_ext,)
        a2 = (ya["h"], ya["u"]) + a1
        for k, (st, a) in enumerate(zip(stage.stages, (a1, a2, a2))):
            max_a = max(max_a, check_kernel(
                f"kernel A {mode} vs plain C{N} stage {k + 1}, {label}",
                st.call_a, st.reference_a, a, a_names, KERNEL_TOL,
                lambda: Pair.launches_a, exact=True))
    timed = [time_form(f"B3 {mode}", st1f, st1f.reference, args,
                       REFUSED_FLOPS_PER_CELL, card)]
    rec_r = mode_record("cov_stage_refused_nu4", mode,
                        "jaxstream/ops/pallas/swe_cov.py:2843", launches[0],
                        max_r, timed, card)
    s1, s2, s3 = stage.stages
    timed = [time_form(f"A {mode} {sl}", st.call_a, st.reference_a, a,
                       A_FLOPS_PER_CELL, card)
             for sl, st, a in (("stage 1", s1, a1), ("stage 2", s2, a2),
                               ("stage 3", s3, a2))]
    dev_us = sum(t[4] for t in timed) / len(timed) * 1e3
    bound_us = sum(t[2] for t in timed) / len(timed) * 1e3
    log(f"cov_stage_nu4_a {mode}: device {dev_us:.2f} us/launch as a CUDA "
        f"graph, events {sum(t[0] for t in timed) / len(timed) * 1e3:.2f};"
        f" bound {bound_us:.2f} us, {bound_us / dev_us:.1%} of it; card "
        f"{card}")
    rec_a = record(f"cov_stage_nu4_a {mode}",
                   "jaxstream_torch/csrc/cov_stage_nu4.cu",
                   "jaxstream/ops/pallas/swe_cov.py:2392", launches[1],
                   max_a, timed)
    if mode == "ppm":
        log(f"PPM Galewsky steps: device re-fused "
            f"{step_device_us(refused, yrun, trun, GAL_DT):.2f}, in-stage "
            f"{step_device_us(stage, ysrun, tsrun, GAL_DT):.2f} us/step as "
            f"CUDA graphs of {GRAPH_STEPS} steps; card {card}")
    return [rec_r, rec_a]


def ppm_refused_simulation(card: str) -> None:
    """Phase 57: ``examples/configs/galewsky_c384.yaml`` read by the
    port's loader and changed to PPM, halo 3 and ``nu4_mode: refused``,
    its io moved into a directory of ``build/`` (strides
    PPM_REFUSED_SIM_STRIDE), ``run(nsteps=PPM_REFUSED_SIM_STEPS)``: the
    re-fused stepper in mode PPM taken, B3 once and B1 twice a step,
    finite, and bitwise equal to its stepper with the same
    segmentation."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from jaxstream_torch.config import load_config
    from jaxstream_torch.ops.cuda.swe_cov import (CovStageCompact,
                                                  CovStageRefusedNu4)
    from jaxstream_torch.simulation import Simulation

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_sim_",
                            dir=os.path.join(here, "build"))
    try:
        cfg = load_config(os.path.join(here, SIM_GAL_CONFIG))
        cfg = dataclasses.replace(
            cfg, grid=dataclasses.replace(cfg.grid, halo=3),
            model=dataclasses.replace(cfg.model, scheme="ppm",
                                      nu4_mode="refused"))
        cfg = with_io(cfg, root, "gal_ppm", PPM_REFUSED_SIM_STRIDE)
        sim = Simulation(cfg)
        st = sim._fused_step.stage1f
        if (sim.stepper_kind != "compact" or sim.grid.halo != 3
                or not isinstance(st, CovStageRefusedNu4)
                or st.mode != "ppm"):
            raise RuntimeError("Galewsky PPM refused config: not the "
                               "re-fused PPM stepper")
        c0 = {k: v.clone() for k, v in sim.state.items()}
        CovStageRefusedNu4.launches = CovStageCompact.launches = 0
        t0 = time.perf_counter()
        sim.run(nsteps=PPM_REFUSED_SIM_STEPS)
        wall = time.perf_counter() - t0
        launches = (CovStageRefusedNu4.launches, CovStageCompact.launches)
        log(f"Simulation Galewsky PPM re-fused (halo 3) C{N}: "
            f"{PPM_REFUSED_SIM_STEPS} steps in {wall:.3f} s "
            f"({PPM_REFUSED_SIM_STEPS / wall:.1f} steps/s); launches (B3, "
            f"B1) {launches} (want ({PPM_REFUSED_SIM_STEPS}, "
            f"{2 * PPM_REFUSED_SIM_STEPS})); card {card}")
        if launches != (PPM_REFUSED_SIM_STEPS, 2 * PPM_REFUSED_SIM_STEPS):
            raise RuntimeError("Simulation Galewsky PPM re-fused: launches")
        if not all(bool(torch.isfinite(v).all())
                   for v in sim.state.values()):
            raise RuntimeError("Simulation Galewsky PPM: state not finite")
        check_io("Simulation Galewsky PPM re-fused", sim,
                 PPM_REFUSED_SIM_STEPS, PPM_REFUSED_SIM_STRIDE)
        m = sim.model
        ref, t = segmented(m, m.make_fused_step(cfg.time.dt,
                                                nu4_mode="refused"),
                           m.compact_state, c0, cfg.time.dt,
                           PPM_REFUSED_SIM_STEPS, PPM_REFUSED_SIM_STRIDE)
        hold_bitwise("Simulation Galewsky PPM re-fused", sim, ref, t)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def router_free_and_nu4_recon_paths(card: str, t_start: float) -> list:
    """Phases 53-57: every reconstruction besides PLR-MC on B13 and B12
    (:func:`router_free_mode_path`) and on B3 and B7 A
    (:func:`nu4_mode_path`), then the PPM re-fused ``Simulation``.
    Returns the records."""
    records = []
    for mode in RECON_MODES:
        stamp(t_start, f"router-free {mode} (phases 53-54)")
        records += router_free_mode_path(card, mode)
        stamp(t_start, f"Galewsky del^4 {mode} (phases 55-56)")
        records += nu4_mode_path(card, mode)
    stamp(t_start, "Simulation: Galewsky PPM re-fused (phase 57)")
    ppm_refused_simulation(card)
    return records


# ---- the ensemble, carry and precision knobs (phases 58-66) ----------------

#: B1 and B3's replaced TPU kernels; B2's and B8's.
B1_REPLACES = "jaxstream/ops/pallas/swe_cov.py:1989"
B2_REPLACES = "jaxstream/ops/pallas/swe_cov.py:2544"
B3_REPLACES = "jaxstream/ops/pallas/swe_cov.py:2843"
B8_REPLACES = "jaxstream/ops/pallas/swe_cov.py:1243"
#: The ensemble sizes of the JAX package's server buckets
#: (``serve.buckets: "1,4,16"``, jaxstream/config.py:283).
ENSEMBLE_SIZES = (4, 16)
ENSEMBLE_CHECK_STEPS = 3
#: Steps of each policy instance's own short run (phase 66).
POLICY_MODE_STEPS = 3
#: Phase 65's filter-cycling interval (the split stepper's ``interval``),
#: its steps held bitwise against the hand composition, and the chunks
#: in which it is then run towards day 6.
FILTER_INTERVAL = 2
INTERVAL_CHECK_STEPS = 20
INTERVAL_CHUNK_STEPS = 240
#: The bf16 carry's mass band: bench.py documents the bf16 h-anomaly
#: carry's leak (1.3e-3 per day) and the 3e-2 band it needed
#: (bench.py:521-527, the line the mixed16 carry replaced, which holds
#: TC5's 1e-3).  The run is also held to twice that leak rate over its
#: own length (2.26e-3 at 0.868 days; PERF.md has the reading).
BF16_CARRY_MASS_TOL = 3e-2
BF16_CARRY_LEAK_PER_DAY = 2 * 1.3e-3
#: The bf16 Galewsky jets' bound on max|zeta| in the resting south at day
#: 6, twice the f32 gate's 5e-6: the bf16 policy's rounding stirs the
#: resting flow in the JAX package's jet as in the port's.  At C96 on the
#: CPU (``scripts/torch_precision_probe.py galewsky6``) both packages'
#: f32 jets reach 1.9e-7 (split) and 2.4e-7 (re-fused), the JAX package's
#: bf16 jets 1.27e-5 and 1.22e-5, the port's 1.06e-5 and 8.6e-6.
GAL_BF16_S_LIMIT = 1e-5
#: Phase 64's Simulation runs: steps, and io strides (segments).
SIM_POLICY_STEPS = 200
SIM_POLICY_STRIDE = 100


def _fold(x, lead: int = 0):
    """(B, 6, ...) -> (6B, ...) at axis ``lead`` (a view)."""
    return x.reshape(x.shape[:lead] + (-1,) + x.shape[lead + 2:])


def policy_record(name: str, source: str, replaces: str, launches: int,
                  max_abs: float, timed, card: str) -> dict:
    """The kernels-line record of a policy instance ``name``, its device
    time per launch as a CUDA graph logged beside its bound."""
    dev_us = sum(t[4] for t in timed) / len(timed) * 1e3
    bound_us = sum(t[2] for t in timed) / len(timed) * 1e3
    log(f"{name}: device {dev_us:.2f} us/launch as a CUDA graph, events "
        f"{sum(t[0] for t in timed) / len(timed) * 1e3:.2f}; bound "
        f"{bound_us:.2f} us, {bound_us / dev_us:.1%} of it; card {card}")
    return record(name, source, replaces, launches, max_abs, timed)


def _same(x, lead: int = 0):
    return x


def check_stages(label: str, stages, y, route, b_ext, fold=_same,
                 with_probe: bool = True) -> float:
    """B1 (``stages``, one stepper's three) as stages 1-3 and, with
    ``with_probe``, stage 3 with y0 = -2 yc, bitwise against the plain
    version on the carry ``y`` routed by ``route``; returns the largest
    absolute difference."""
    from jaxstream_torch.ops.cuda import swe_cov

    hc, uc = fold(y["h"]), fold(y["u"], 1)
    gsn, gwe = (fold(r) for r in route(y["strips_sn"], y["strips_we"]))
    b = b_ext
    st1, st2, st3 = stages
    cases = [("stage 1", st1, (hc, uc, gsn, gwe, b), KERNEL_TOL),
             ("stage 2", st2, (hc, uc, hc, uc, gsn, gwe, b), KERNEL_TOL),
             ("stage 3", st3, (hc, uc, hc, uc, gsn, gwe, b), KERNEL_TOL)]
    if with_probe:
        cases.append(("stage 3, y0=-2yc", st3,
                      (-2.0 * hc, -2.0 * uc, hc, uc, gsn, gwe, b),
                      TENDENCY_TOL))
    names = ("h", "u", "strips_sn", "strips_we")
    count = lambda: swe_cov.CovStageCompact.launches
    return max(check_kernel(f"{label} {nm}", st, st.reference, a, names,
                            tol, count, exact=True)
               for nm, st, a, tol in cases)


def time_stages(label: str, stages, y, route, b_ext, card: str,
                cells: int | None = None, fold=_same) -> list:
    """time_form of the three stages of one stepper on the carry ``y``."""
    hc, uc = fold(y["h"]), fold(y["u"], 1)
    gsn, gwe = (fold(r) for r in route(y["strips_sn"], y["strips_we"]))
    st1, st2, st3 = stages
    extra = () if cells is None else (cells,)
    return [time_form(f"{label} {nm}", st, st.reference, a, FLOPS_PER_CELL,
                      card, *extra)
            for nm, st, a in (("stage 1", st1, (hc, uc, gsn, gwe, b_ext)),
                              ("stage 2", st2, (hc, uc, hc, uc, gsn, gwe,
                                                b_ext)),
                              ("stage 3", st3, (hc, uc, hc, uc, gsn, gwe,
                                                b_ext)))]


def ensemble_path(card: str, grid, model, h_ext, v_ext, step) -> dict:
    """Phases 58-59: TC5 with ``perturbed_ensemble`` members on the
    batched fused stepper (B1's float32 ensemble instance, PLR-MC,
    ``cov_stage_members.cu``).
    Returns the instance's record."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.physics.initial_conditions import perturbed_ensemble
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageCompact
    B_big = ENSEMBLE_SIZES[-1]
    hb = perturbed_ensemble(grid, h_ext, B_big, seed=0, amplitude=1e-3)
    members = [model.initial_state(hb[i], v_ext) for i in range(B_big)]
    max_abs, records = 0.0, None
    for B in ENSEMBLE_SIZES:
        stepb = model.make_fused_step(STEP_DT, ensemble=B)
        yb = model.ensemble_compact_state(model.stack_ensemble(members[:B]))
        # ---- 58. the batched launch bitwise; members bitwise single runs
        max_abs = max(max_abs, check_stages(
            f"B1 members mc f32 (B={B}) vs plain C{N}", stepb.stages, yb,
            stepb.route, model.b_ext, fold=_fold))
        if B == ENSEMBLE_SIZES[0]:
            yk, _ = integrate(stepb, yb, 0.0, ENSEMBLE_CHECK_STEPS, STEP_DT)
            bad = []
            for i in range(B):
                yi, _ = integrate(step, model.compact_state(members[i]), 0.0,
                                  ENSEMBLE_CHECK_STEPS, STEP_DT)
                bad += [(i, k) for k in yi if not torch.equal(
                    yk[k][:, i] if k == "u" else yk[k][i], yi[k])]
            log(f"ensemble B={B}, {ENSEMBLE_CHECK_STEPS} steps: each member "
                "of the batched run vs its single-member run (cov_stage.cu's "
                "stepper): " + ("bitwise equal" if not bad else
                                f"DIFFERS at {bad}"))
            if bad:
                raise RuntimeError("ensemble members differ from their "
                                   "single runs")
            del yk
            continue
        # ---- 59. B = 16: 500 steps gated, rates, device, memory --------
        y, t = integrate(stepb, yb, 0.0, WARM_STEPS, STEP_DT)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        Stage.launches = 0
        t0 = time.perf_counter()
        y, t = integrate(stepb, y, t, TIMED_STEPS, STEP_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = Stage.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        if launches != 3 * TIMED_STEPS:
            raise RuntimeError(f"ensemble stage launches {launches} != 3 x "
                               f"{TIMED_STEPS}")
        for i in range(B):
            tc5_gate(f"ensemble B={B} member {i}", grid, members[i],
                     y["h"][i], (WARM_STEPS + TIMED_STEPS) * STEP_DT
                     / 86400.0)
        steps_s = TIMED_STEPS / wall
        dev_us = step_device_us(stepb, y, t, STEP_DT)
        log(f"ensemble B={B} C{N} TC5: {TIMED_STEPS} steps in {wall:.3f} s "
            f"-> {steps_s:.1f} steps/s, {B * steps_s:.1f} member-steps/s, "
            f"{1e6 / steps_s:.1f} us/step; device {dev_us:.2f} us/step as a "
            f"CUDA graph ({dev_us / B:.2f} per member); stage launches "
            f"{launches} = 3 x {TIMED_STEPS}; peak memory {peak:.3f} GiB; "
            f"card {card}")
        rb_ms = event_ms(lambda: stepb.route(y["strips_sn"], y["strips_we"]),
                         200)
        y1 = model.compact_state(members[0])
        r1_ms = event_ms(lambda: step.route(y1["strips_sn"], y1["strips_we"]),
                         200)
        log(f"router: B={B} batched {rb_ms * 1e3:.2f} us/call "
            f"({rb_ms * 1e3 / B:.2f} per member) vs one member "
            f"{r1_ms * 1e3:.2f} us/call; card {card}")
        device_busy(lambda: integrate(stepb, y, t, PROFILED_STEPS, STEP_DT),
                    PROFILED_STEPS, 1e6 / steps_s, card,
                    ("cov_stage_members_kernel_mc",))
        max_abs = max(max_abs, check_stages(
            f"B1 members mc f32 (B={B}) vs plain C{N}, after "
            f"{WARM_STEPS + TIMED_STEPS} steps", stepb.stages, y,
            stepb.route, model.b_ext, fold=_fold))
        timed = time_stages(f"B1 members mc f32 B={B}", stepb.stages, y,
                            stepb.route, model.b_ext, card,
                            cells=6 * B * N * N, fold=_fold)
        records = policy_record(
            "cov_stage_members mc f32", "jaxstream_torch/csrc/"
            "cov_stage_members.cu", B1_REPLACES, launches, max_abs, timed,
            card)
        y4 = model.ensemble_compact_state(model.stack_ensemble(
            members[:ENSEMBLE_SIZES[0]]))
        s4 = model.make_fused_step(STEP_DT, ensemble=ENSEMBLE_SIZES[0])
        time_stages(f"B1 members mc f32 B={ENSEMBLE_SIZES[0]}", s4.stages,
                    y4, s4.route, model.b_ext, card,
                    cells=6 * ENSEMBLE_SIZES[0] * N * N, fold=_fold)
        del y, y4
    return records


def bf16_tc5_path(card: str, grid, model, s0, y_f32_at) -> list:
    """Phase 60: compact TC5 under the bf16 stage policy: B1's bf16
    instance bitwise on the TC5 carry, 500 steps gated, the distance
    from the f32 path, times.  Returns the instance's record."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.ops.cuda.precision import encode_strips
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageCompact
    stepb = model.make_fused_step(STEP_DT, precision="bf16")
    y0 = encode_strips(model.compact_state(s0), "bf16")
    max_abs = check_stages(f"B1 bf16 mc vs plain C{N}", stepb.stages, y0,
                           stepb.route, model.b_ext)
    y, t = integrate(stepb, y0, 0.0, WARM_STEPS, STEP_DT)
    torch.cuda.synchronize()
    Stage.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(stepb, y, t, TIMED_STEPS, STEP_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = Stage.launches
    if launches != 3 * TIMED_STEPS:
        raise RuntimeError(f"bf16 stage launches {launches} != 3 x "
                           f"{TIMED_STEPS}")
    tc5_gate("bf16 stage policy", grid, s0, y["h"],
             (WARM_STEPS + TIMED_STEPS) * STEP_DT / 86400.0)
    yf = y_f32_at(WARM_STEPS + TIMED_STEPS)
    steps_s = TIMED_STEPS / wall
    log(f"bf16 policy C{N} TC5: {TIMED_STEPS} steps in {wall:.3f} s -> "
        f"{steps_s:.1f} steps/s; distance from the f32 path after "
        f"{WARM_STEPS + TIMED_STEPS} steps: h {rel_err(yf['h'], y['h']):.3e}"
        f", u {rel_err(yf['u'], y['u']):.3e} of max; device "
        f"{step_device_us(stepb, y, t, STEP_DT):.2f} us/step as a CUDA "
        f"graph; router {event_ms(lambda: stepb.route(y['strips_sn'], y['strips_we']), 200) * 1e3:.2f} us/call; card {card}")
    max_abs = max(max_abs, check_stages(
        f"B1 bf16 mc vs plain C{N}, after {WARM_STEPS + TIMED_STEPS} steps",
        stepb.stages, y, stepb.route, model.b_ext))
    timed = time_stages("B1 bf16 mc", stepb.stages, y, stepb.route,
                        model.b_ext, card)
    return [policy_record("cov_stage_policy mc bf16", "jaxstream_torch/"
                          "csrc/cov_stage_policy_bf16.cu", B1_REPLACES,
                          launches, max_abs, timed, card)]


def carry_paths(card: str, grid, model, s0) -> None:
    """Phase 62: the mixed16 and bf16 TC5 carries, 500 steps each, the
    TC5 gate on the decoded h, B1's policy instance bitwise on the encoded
    carry, and its device time per launch."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.ops.cuda.precision import mixed16_encoding
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageCompact
    h = s0["h"]
    mid = float(0.5 * (float(torch.min(h)) + float(torch.max(h))))
    days = TIMED_STEPS * STEP_DT / 86400.0
    for label, (cd, off, hs), tol in (
            ("mixed16", mixed16_encoding(h), 1e-3),
            ("bf16", ((torch.bfloat16, torch.bfloat16), mid, 1.0),
             min(BF16_CARRY_MASS_TOL, BF16_CARRY_LEAK_PER_DAY * days))):
        stepc = model.make_fused_step(STEP_DT, carry_dtype=cd, h_offset=off,
                                      h_scale=hs)
        y0 = model.encode_carry(model.compact_state(s0), cd, off, hs)
        check_stages(f"B1 policy mc f32 ({label} carry) vs plain C{N}",
                     stepc.stages, y0, stepc.route, model.b_ext,
                     with_probe=False)
        Stage.launches = 0
        t0 = time.perf_counter()
        y, t = integrate(stepc, y0, 0.0, TIMED_STEPS, STEP_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if Stage.launches != 3 * TIMED_STEPS:
            raise RuntimeError(f"{label} carry launches {Stage.launches}")
        dec = model.decode_carry(model.restrict_state(y), off, hs)
        tc5_gate(f"{label} carry", grid, s0, dec["h"], days, mass_tol=tol)
        timed = time_stages(f"B1 policy mc f32 {label} carry", stepc.stages,
                            y, stepc.route, model.b_ext, card)
        dev_us = sum(x[4] for x in timed) / 3 * 1e3
        log(f"{label} carry (h {cd[0]}, u {cd[1]}, h_offset {off:.6g}, "
            f"h_scale {hs:g}) C{N}: {TIMED_STEPS} steps in {wall:.3f} s -> "
            f"{TIMED_STEPS / wall:.1f} steps/s; B1 device {dev_us:.2f} "
            f"us/launch; step device {step_device_us(stepc, y, t, STEP_DT):.2f}"
            f" us as a CUDA graph; card {card}")


def temporal_block_check(model, y0) -> None:
    """Phase 63: the compact step at ``temporal_block = 4`` against 4
    single steps, bitwise."""
    step4 = model.make_fused_step(STEP_DT, temporal_block=4)
    step1 = model.make_fused_step(STEP_DT)
    a = step4(y0, 0.0)
    b = y0
    for k in range(4):
        b = step1(b, k * STEP_DT)
    bad = [k for k in a if not torch.equal(a[k], b[k])]
    log(f"temporal_block=4 (steps_per_call {step4.steps_per_call}) vs 4 "
        "single steps: " + ("bitwise equal" if not bad else f"DIFFERS {bad}"))
    if bad or step4.steps_per_call != 4:
        raise RuntimeError("temporal_block step differs from single steps")


def bf16_galewsky_paths(card: str) -> list:
    """Phases 60-61 and 65: the Galewsky jet under the bf16 policy: B2's
    bf16 instance and B3's bitwise, 3 steps of each bf16 stepper against
    the f32 split one; the re-fused bf16 jet to day 6 under the gate; the
    split filter at ``interval = 2`` (phase 65); last, the split bf16 jet
    to day 6 under the gate.  The bf16 jets' gate bounds the resting
    south by GAL_BF16_S_LIMIT.  Returns B2's and B3's records."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.ops.cuda.precision import encode_strips
    from jaxstream_torch.stepping import integrate

    Stage, Filter = swe_cov.CovStageCompact, swe_cov.CovNu4Filter
    Refused = swe_cov.CovStageRefusedNu4
    gal = Galewsky()
    grid, model = gal.grid, gal.model
    names = ("h", "u", "strips_sn", "strips_we")
    y0 = encode_strips(gal.y0, "bf16")
    split = model.make_fused_step(GAL_DT, precision="bf16")
    refused = model.make_fused_step(GAL_DT, nu4_mode="refused",
                                    precision="bf16")
    # ---- 60. B2 (bf16 strips) and B3 (bf16) bitwise, then 3 steps vs f32
    y1 = split(y0, 0.0)
    args = (y1["h"], y1["u"]) + split.route(y1["strips_sn"],
                                            y1["strips_we"])
    filt = split.filter
    exact = filt.reference(*[a.double() if a.dtype == torch.float32 else a
                             for a in args])
    scale, _ = probe_scale((args[0], args[1][0], args[1][1]),
                           (exact[0], exact[1][0], exact[1][1]))
    probe = swe_cov.make_cov_nu4_filter(grid, GAL_NU4 * scale, filt.dt_eff,
                                        precision="bf16")
    fcount = lambda: Filter.launches
    f_abs = max(check_kernel(f"B2 bf16 strips vs plain C{N} {nm}", f,
                             f.reference, args, names, tol, fcount,
                             exact=True)
                for nm, f, tol in (("filter", filt, KERNEL_TOL),
                                   ("probe", probe, PROBE_TOL)))
    st1f = refused.stage1f
    y1r = refused(y0, 0.0)
    rargs = (y1r["h"], y1r["u"]) + refused.route(
        y1r["strips_sn"], y1r["strips_we"]) + (model.b_ext,)
    rnames = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")
    rcount = lambda: Refused.launches
    r_abs = check_kernel(f"B3 bf16 mc vs plain C{N}", st1f, st1f.reference,
                         rargs, rnames, KERNEL_TOL, rcount, exact=True)
    yref, _ = integrate(model.make_fused_step(GAL_DT), gal.y0, 0.0, 3,
                        GAL_DT)
    for label, stp in (("split", split), ("re-fused", refused)):
        yb, _ = integrate(stp, y0, 0.0, 3, GAL_DT)
        log(f"Galewsky bf16 {label} vs f32 split C{N}, 3 steps: h "
            f"{rel_err(yref['h'], yb['h']):.3e}, u "
            f"{rel_err(yref['u'], yb['u']):.3e} of max")
    del yref
    # ---- 61. the re-fused bf16 jet to day 6 under the gate --------------
    Stage.launches = Refused.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(refused, y0, 0.0, GAL_DAY6_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (Stage.launches, Refused.launches)
    if got != (2 * GAL_DAY6_STEPS, GAL_DAY6_STEPS):
        raise RuntimeError(f"re-fused bf16: launches (B1, B3) {got}")
    gal.gate("re-fused bf16", y, t, f"launches (B1, B3) {got}; "
             f"{GAL_DAY6_STEPS} steps in {wall:.2f} s "
             f"({GAL_DAY6_STEPS / wall:.1f} steps/s)",
             s_limit=GAL_BF16_S_LIMIT)
    log(f"Galewsky re-fused bf16 C{N}: device "
        f"{step_device_us(refused, y, t, GAL_DT):.2f} us/step as a CUDA "
        f"graph; card {card}")
    ra = (y["h"], y["u"]) + refused.route(y["strips_sn"],
                                          y["strips_we"]) + (model.b_ext,)
    r_abs = max(r_abs, check_kernel(
        f"B3 bf16 mc vs plain C{N}, day 6", st1f,
        st1f.reference, ra, rnames, KERNEL_TOL, rcount, exact=True))
    records = [policy_record(
        "cov_stage_refused_nu4_policy mc bf16", "jaxstream_torch/csrc/"
        "cov_stage_refused_nu4_policy_bf16.cu", B3_REPLACES, got[1], r_abs,
        [time_form("B3 bf16 mc", st1f, st1f.reference, ra,
                   REFUSED_FLOPS_PER_CELL, card)], card)]
    # ---- 65. the split filter every second step on the card -------------
    cyc = swe_cov.make_fused_ssprk3_cov_split_nu4(
        grid, model.gravity, model.omega, GAL_DT, model.b_ext, GAL_NU4,
        interval=FILTER_INTERVAL)
    Stage.launches = Filter.launches = 0
    y, t = integrate(cyc, dict(gal.y0, filter_k=0), 0.0,
                     INTERVAL_CHECK_STEPS, GAL_DT)
    torch.cuda.synchronize()
    got = (Stage.launches, Filter.launches)
    if got != (3 * INTERVAL_CHECK_STEPS,
               INTERVAL_CHECK_STEPS // FILTER_INTERVAL):
        raise RuntimeError(f"interval={FILTER_INTERVAL}: launches {got}")
    # The same steps by hand: the compact step, and every second step a
    # route and the filter at twice the coefficient.
    adv = swe_cov.make_fused_ssprk3_cov_compact(
        grid, model.gravity, model.omega, GAL_DT, model.b_ext)
    f2 = swe_cov.make_cov_nu4_filter(grid, GAL_NU4, FILTER_INTERVAL * GAL_DT)
    yh = gal.y0
    for k in range(INTERVAL_CHECK_STEPS):
        yh = adv(yh, 0.0)
        if k % FILTER_INTERVAL == FILTER_INTERVAL - 1:
            yh = dict(zip(names, f2(yh["h"], yh["u"], *adv.route(
                yh["strips_sn"], yh["strips_we"]))))
    bad = [k for k in names if not torch.equal(yh[k], y[k])]
    log(f"split, interval={FILTER_INTERVAL} C{N}: {INTERVAL_CHECK_STEPS} "
        f"steps, launches (B1, B2) {got}, against the compact step and the "
        f"filter of {FILTER_INTERVAL} dt every {FILTER_INTERVAL}nd step by "
        "hand: " + ("bitwise equal" if not bad else f"DIFFERS in {bad}"))
    if bad:
        raise RuntimeError("the filter-cycling step differs from its parts")
    # Towards day 6 in chunks: this configuration's filter is past the
    # explicit del^4 stability limit (PERF.md), so the first non-finite
    # chunk is reported, not gated.
    t0 = time.perf_counter()
    done = INTERVAL_CHECK_STEPS
    while done < GAL_DAY6_STEPS and bool(torch.isfinite(y["h"]).all()):
        y, t = integrate(cyc, y, t, INTERVAL_CHUNK_STEPS, GAL_DT)
        done += INTERVAL_CHUNK_STEPS
    finite = bool(torch.isfinite(y["h"]).all())
    log(f"split, interval={FILTER_INTERVAL} C{N} towards day 6 (measured, "
        f"not gated): " + (f"finite through step {done} (day "
                           f"{t / 86400.0:g}), mass drift "
                           f"{gal.drift(y['h']):.3e}" if finite else
                           f"non-finite by step {done}, finite at step "
                           f"{done - INTERVAL_CHUNK_STEPS}")
        + f"; {time.perf_counter() - t0:.2f} s; card {card}")
    # At half the coefficient the filter of two steps is the single-step
    # filter's (nu4 dt / dx^4 as at interval 1): to day 1 under the gate.
    cyc = swe_cov.make_fused_ssprk3_cov_split_nu4(
        grid, model.gravity, model.omega, GAL_DT, model.b_ext,
        GAL_NU4 / FILTER_INTERVAL, interval=FILTER_INTERVAL)
    Stage.launches = Filter.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(cyc, dict(gal.y0, filter_k=0), 0.0, GAL_DAY1_STEPS,
                     GAL_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (Stage.launches, Filter.launches)
    if got != (3 * GAL_DAY1_STEPS, GAL_DAY1_STEPS // FILTER_INTERVAL):
        raise RuntimeError(f"interval={FILTER_INTERVAL}: launches {got}")
    gal.gate(f"split, interval={FILTER_INTERVAL}, nu4 "
             f"{GAL_NU4 / FILTER_INTERVAL:g}", y, t,
             f"launches (B1, B2) {got}; {GAL_DAY1_STEPS} steps in "
             f"{wall:.2f} s ({GAL_DAY1_STEPS / wall:.1f} steps/s)")
    # ---- 61. the split bf16 jet to day 6 under the gate ---------------------
    Stage.launches = Filter.launches = 0
    t0 = time.perf_counter()
    y, t = integrate(split, y0, 0.0, GAL_DAY6_STEPS, GAL_DT)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = (Stage.launches, Filter.launches)
    if got != (3 * GAL_DAY6_STEPS, GAL_DAY6_STEPS):
        raise RuntimeError(f"split bf16: launches (B1, B2) {got}")
    gal.gate("split bf16", y, t, f"launches (B1, B2) {got}; "
             f"{GAL_DAY6_STEPS} steps in {wall:.2f} s "
             f"({GAL_DAY6_STEPS / wall:.1f} steps/s)",
             s_limit=GAL_BF16_S_LIMIT)
    ga = (y["h"], y["u"]) + split.route(y["strips_sn"], y["strips_we"])
    f_abs = max(f_abs, check_kernel(
        f"B2 bf16 strips vs plain C{N}, day 6", filt, filt.reference, ga,
        names, KERNEL_TOL, fcount, exact=True))
    records.append(policy_record(
        "cov_nu4_filter bf16", "jaxstream_torch/csrc/cov_nu4_filter_bf16.cu",
        B2_REPLACES, got[1], f_abs,
        [time_form("B2 bf16 strips", filt, filt.reference, ga,
                   FILTER_FLOPS_PER_CELL, card)], card))
    log(f"Galewsky split bf16 C{N}: device "
        f"{step_device_us(split, y, t, GAL_DT):.2f} us/step as a CUDA "
        f"graph; card {card}")
    del gal
    return records


def policy_simulations(card: str, t_start: float) -> None:
    """Phase 64: ``Simulation`` of TC5 with ``ensemble.members: 4`` and
    ``precision.stage: bf16``, and with ``precision.carry: mixed16``; each
    bitwise its stepper under ``integrate`` with the same segmentation
    (prep, steps, restrict and decode per segment)."""
    import os
    import shutil
    import tempfile

    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.ops.cuda.precision import (encode_strips,
                                                    mixed16_encoding)
    from jaxstream_torch.simulation import Simulation
    from jaxstream_torch.stepping import integrate

    Stage = swe_cov.CovStageCompact
    root = tempfile.mkdtemp(prefix="chip_smoke_sim_policy_",
                            dir=os.path.join(os.path.dirname(
                                os.path.abspath(__file__)), "build"))
    try:
        for tag, extra in (
                ("ensemble_bf16", {"ensemble": {"members": 4, "seed": 0},
                                   "precision": {"stage": "bf16"}}),
                ("mixed16", {"precision": {"carry": "mixed16"}})):
            cfg = sim_tc5_config(root, tag)
            cfg["time"]["nsteps"] = SIM_POLICY_STEPS
            cfg["io"]["history_stride"] = SIM_POLICY_STRIDE
            cfg["io"]["checkpoint_stride"] = SIM_POLICY_STRIDE
            cfg.update(extra)
            sim = Simulation(cfg)
            m = sim.model
            s0 = dict(sim.state)
            Stage.launches = 0
            t0 = time.perf_counter()
            sim.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if Stage.launches != 3 * SIM_POLICY_STEPS:
                raise RuntimeError(f"Simulation {tag}: launches "
                                   f"{Stage.launches}")
            if tag == "ensemble_bf16":
                step = m.make_fused_step(STEP_DT, ensemble=4,
                                         precision="bf16")

                def prep(s):
                    return encode_strips(m.ensemble_compact_state(s), "bf16")
                post = None
                for i in range(4):
                    tc5_gate(f"Simulation {tag} member {i}", sim.grid,
                             {"h": s0["h"][i]}, sim.state["h"][i],
                             SIM_POLICY_STEPS * STEP_DT / 86400.0)
            else:
                cd, off, hs = mixed16_encoding(s0["h"])
                step = m.make_fused_step(STEP_DT, carry_dtype=cd,
                                         h_offset=off, h_scale=hs)

                def prep(s, cd=cd, off=off, hs=hs):
                    return m.encode_carry(m.compact_state(s), cd, off, hs)

                def post(s, off=off, hs=hs):
                    return m.decode_carry(s, off, hs)
                tc5_gate(f"Simulation {tag}", sim.grid, s0, sim.state["h"],
                         SIM_POLICY_STEPS * STEP_DT / 86400.0)
            s, t = s0, 0.0
            for _ in range(SIM_POLICY_STEPS // SIM_POLICY_STRIDE):
                y, t = integrate(step, prep(s), t, SIM_POLICY_STRIDE,
                                 STEP_DT)
                s, t = m.restrict_state(y), float(t)
                if post is not None:
                    s = post(s)
            hold_bitwise(f"Simulation {tag}", sim, s, t)
            check_io(f"Simulation {tag}", sim, SIM_POLICY_STEPS,
                     SIM_POLICY_STRIDE)
            log(f"Simulation {tag} C{N}: {SIM_POLICY_STEPS} steps in "
                f"{wall:.2f} s (io included); diagnostics "
                + ", ".join(f"{k} {v:.6g}" for k, v in
                            sim.diagnostics().items()) + f"; card {card}")
            del sim
    finally:
        shutil.rmtree(root, ignore_errors=True)


def policy_mode_paths(card: str) -> list:
    """Phase 66: every other policy instance on its own short run (the
    launches counted) and bitwise against its plain version on the carry
    it reached: for each PLR limiter besides MC, B1 under the bf16 policy
    and under bf16 strips alone, B3 under both (TC5's orography, nu4 =
    1e14, re-fused), B8 under bf16 compute; PPM (halo 3) under bf16
    strips on B1 and B3; B3 under bf16 strips alone in PLR-MC.  Returns
    the instances' records.  Each reconstruction besides PLR-MC also
    runs B1's float32 ensemble instance (two members)."""
    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.ops.cuda.precision import encode_strips
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    Stage, Refused = swe_cov.CovStageCompact, swe_cov.CovStageRefusedNu4
    Ink = swe_cov.CovStageInkernel
    strips = {"stage": "f32", "strips": "bf16"}
    grids = {}
    records = []
    rnames = ("h1", "u1", "h0f", "u0f", "strips_sn", "strips_we")
    cases = [(lim, "bf16") for lim in ("none", "minmod", "mc_sign",
                                       "vanleer")]
    cases += [(lim, "strips") for lim in ("none", "minmod", "mc_sign",
                                          "vanleer", "ppm")]
    cases += [("mc", "strips")]
    for limiter, kind in cases:
        scheme = "ppm" if limiter == "ppm" else "plr"
        lim = "mc" if limiter == "ppm" else limiter
        halo = 3 if scheme == "ppm" else 2
        if halo not in grids:
            g = build_grid(N, halo=halo, radius=EARTH_RADIUS,
                           dtype=torch.float32)
            grids[halo] = (g,) + williamson_tc5(g, EARTH_GRAVITY,
                                                EARTH_OMEGA)
        g, h_ext, v_ext, b_ext = grids[halo]
        pol = "bf16" if kind == "bf16" else strips
        compute = "bf16" if kind == "bf16" else "f32"
        tag = f"{limiter} {compute}"
        m = CovariantShallowWater(g, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext,
                                  scheme=scheme, limiter=lim)
        s0 = m.initial_state(h_ext, v_ext)
        y0 = encode_strips(m.compact_state(s0), pol)
        # B1's instance: its own stepper, then bitwise on its carry.
        stp = m.make_fused_step(STEP_DT, precision=pol)
        Stage.launches = 0
        y, t = integrate(stp, y0, 0.0, POLICY_MODE_STEPS, STEP_DT)
        torch.cuda.synchronize()
        n1 = Stage.launches
        if n1 != 3 * POLICY_MODE_STEPS or not bool(
                torch.isfinite(y["h"]).all()):
            raise RuntimeError(f"B1 policy {tag}: launches {n1}")
        a1 = check_stages(f"B1 policy {tag} vs plain C{N}", stp.stages, y,
                          stp.route, m.b_ext)
        lib = ("cov_stage_policy_bf16" if compute == "bf16"
               else "cov_stage_policy")
        records.append(policy_record(
            f"cov_stage_policy {tag}", f"jaxstream_torch/csrc/{lib}.cu",
            B1_REPLACES, n1, a1, time_stages(
                f"B1 policy {tag}", stp.stages, y, stp.route, m.b_ext,
                card), card))
        if kind == "strips" and limiter != "mc":
            # B1's float32 ensemble instance of the mode (PLR-MC's is
            # phase 58's): two members, the second's h 5e-4 higher.
            ste = m.make_fused_step(STEP_DT, ensemble=2)
            ye = m.ensemble_compact_state(m.stack_ensemble(
                [s0, dict(s0, h=s0["h"] * 1.0005)]))
            Stage.launches = 0
            ye, _ = integrate(ste, ye, 0.0, POLICY_MODE_STEPS, STEP_DT)
            torch.cuda.synchronize()
            ne = Stage.launches
            if ne != 3 * POLICY_MODE_STEPS or not bool(
                    torch.isfinite(ye["h"]).all()):
                raise RuntimeError(f"B1 members {limiter}: launches {ne}")
            ae = check_stages(f"B1 members {limiter} f32 (B=2) vs plain "
                              f"C{N}", ste.stages, ye, ste.route, m.b_ext,
                              fold=_fold)
            records.append(policy_record(
                f"cov_stage_members {limiter} f32",
                "jaxstream_torch/csrc/cov_stage_members.cu", B1_REPLACES, ne,
                ae, time_stages(f"B1 members {limiter} f32 B=2", ste.stages,
                                ye, ste.route, m.b_ext, card,
                                cells=12 * N * N, fold=_fold), card))
        # B3's instance: TC5 with nu4 = 1e14 on the re-fused stepper.
        m4 = CovariantShallowWater(g, gravity=EARTH_GRAVITY,
                                   omega=EARTH_OMEGA, b_ext=b_ext,
                                   scheme=scheme, limiter=lim, nu4=GAL_NU4)
        stp = m4.make_fused_step(STEP_DT, nu4_mode="refused", precision=pol)
        Refused.launches = 0
        y, t = integrate(stp, y0, 0.0, POLICY_MODE_STEPS, STEP_DT)
        torch.cuda.synchronize()
        n3 = Refused.launches
        if n3 != POLICY_MODE_STEPS or not bool(torch.isfinite(y["h"]).all()):
            raise RuntimeError(f"B3 policy {tag}: launches {n3}")
        ra = (y["h"], y["u"]) + stp.route(y["strips_sn"], y["strips_we"]) \
            + (m4.b_ext,)
        st1f = stp.stage1f
        a3 = check_kernel(f"B3 policy {tag} vs plain C{N}", st1f,
                          st1f.reference, ra, rnames, KERNEL_TOL,
                          lambda: Refused.launches, exact=True)
        lib = ("cov_stage_refused_nu4_policy_bf16" if compute == "bf16"
               else "cov_stage_refused_nu4_policy")
        records.append(policy_record(
            f"cov_stage_refused_nu4_policy {tag}",
            f"jaxstream_torch/csrc/{lib}.cu", B3_REPLACES, n3, a3,
            [time_form(f"B3 policy {tag}", st1f, st1f.reference, ra,
                       REFUSED_FLOPS_PER_CELL, card)], card))
        if kind != "bf16":
            continue
        # B8's bf16 instance: the extended carry.
        stp = m.make_fused_step(STEP_DT, compact=False,
                                precision={"stage": "bf16", "strips": "f32"})
        Ink.launches = 0
        y, t = integrate(stp, m.extend_state(s0, with_strips=True), 0.0,
                         POLICY_MODE_STEPS, STEP_DT)
        torch.cuda.synchronize()
        n8 = Ink.launches
        if n8 != 3 * POLICY_MODE_STEPS:
            raise RuntimeError(f"B8 bf16 {limiter}: launches {n8}")
        ghosts = stp.route(y["strips"])
        st1, st2, _ = stp.stages
        forms = (("stage 1", st1, (y["h"], y["u"], ghosts, m.b_ext)),
                 ("stage 2", st2, (y["h"], y["u"], y["h"], y["u"], ghosts,
                                   m.b_ext)))
        a8 = max(check_kernel(f"B8 bf16 {limiter} {nm} vs plain C{N}", st,
                              st.reference, a, ("h", "u", "strips"),
                              KERNEL_TOL, lambda: Ink.launches, exact=True)
                 for nm, st, a in forms)
        records.append(policy_record(
            f"cov_stage_inkernel {limiter} bf16", "jaxstream_torch/csrc/"
            "cov_stage_inkernel_bf16.cu", B8_REPLACES, n8, a8,
            [time_form(f"B8 bf16 {limiter} {nm}", st, st.reference, a,
                       FLOPS_PER_CELL, card) for nm, st, a in forms], card))
    # B8 bf16 in PLR-MC: the extended TC5 carry.
    g, h_ext, v_ext, b_ext = grids[2]
    m = CovariantShallowWater(g, gravity=EARTH_GRAVITY, omega=EARTH_OMEGA,
                              b_ext=b_ext)
    stp = m.make_fused_step(STEP_DT, compact=False,
                            precision={"stage": "bf16", "strips": "f32"})
    Ink.launches = 0
    y, t = integrate(stp, m.extend_state(m.initial_state(h_ext, v_ext),
                                         with_strips=True), 0.0,
                     POLICY_MODE_STEPS, STEP_DT)
    torch.cuda.synchronize()
    n8 = Ink.launches
    ghosts = stp.route(y["strips"])
    st1, st2, _ = stp.stages
    forms = (("stage 1", st1, (y["h"], y["u"], ghosts, m.b_ext)),
             ("stage 2", st2, (y["h"], y["u"], y["h"], y["u"], ghosts,
                               m.b_ext)))
    a8 = max(check_kernel(f"B8 bf16 mc {nm} vs plain C{N}", st,
                          st.reference, a, ("h", "u", "strips"), KERNEL_TOL,
                          lambda: Ink.launches, exact=True)
             for nm, st, a in forms)
    if n8 != 3 * POLICY_MODE_STEPS:
        raise RuntimeError(f"B8 bf16 mc: launches {n8}")
    records.append(policy_record(
        "cov_stage_inkernel mc bf16", "jaxstream_torch/csrc/"
        "cov_stage_inkernel_bf16.cu", B8_REPLACES, n8, a8,
        [time_form(f"B8 bf16 mc {nm}", st, st.reference, a, FLOPS_PER_CELL,
                   card) for nm, st, a in forms], card))
    return records


def policy_paths(card: str, t_start: float, grid, model, h_ext, v_ext,
                 step, s0) -> list:
    """Phases 58-66 (see the module docstring).  Returns the records of
    the policy instances for the kernels line."""
    from jaxstream_torch.stepping import integrate

    y0 = model.compact_state(s0)
    records = []
    stamp(t_start, "ensembles (phases 58-59)")
    records.append(ensemble_path(card, grid, model, h_ext, v_ext, step))
    stamp(t_start, "bf16 stage policy, TC5 (phase 60)")
    records += bf16_tc5_path(
        card, grid, model, s0,
        lambda k: integrate(step, y0, 0.0, k, STEP_DT)[0])
    stamp(t_start, "carry encodings (phase 62)")
    carry_paths(card, grid, model, s0)
    temporal_block_check(model, y0)
    stamp(t_start, "Simulation: ensemble + bf16, mixed16 (phase 64)")
    policy_simulations(card, t_start)
    stamp(t_start, "the other policy instances (phase 66)")
    records += policy_mode_paths(card)
    stamp(t_start, "bf16 Galewsky, interval 2 (phases 60-61, 65)")
    records += bf16_galewsky_paths(card)
    return records


# Phases 67-74: queue A items 1 and 2 on the card (lazy metrics, the
# in-loop telemetry, guards, sink, flight recorder and async pipeline).
#: The io modes' windows: a warm-up of one io stride (so the timed
#: window's boundaries fall on the strides), then OBS_STEPS timed steps.
OBS_STRIDE = 100
OBS_STEPS = 1000
OBS_INTERVAL = 10
#: Phase 68: one metric sample timed over this many calls.
SAMPLE_REPS = 200
#: Phase 69: a run of GUARD_STEPS with the stream's fault at GUARD_FAULT.
GUARD_STEPS = 500
GUARD_FAULT = 250
GAL_OBS_INTERVAL = 60
ENS_OBS_MEMBERS = 16
ENS_OBS_WINDOW = 250
FACE_OBS_STEPS = 20
LAZY_WINDOW = 500
LAZY_CLASSIC_STEPS = 3
FLIGHT_WINDOWS, FLIGHT_K, FLIGHT_REPEATS = 12, 4, 9
#: The sink's float32 mass drift against the gate's float64 one.
DRIFT_TOL = 2e-6
_VOLATILE = ("wall_s", "steps_per_sec", "sim_days_per_sec_per_chip",
             "host_wait_s", "created_unix")


def obs_tc5_config(root: str, tag: str, mode: str, **obs) -> dict:
    """TC5 at C384 on the compact stepper: ``mode`` 'off' (no io, no
    telemetry), 'sync' or 'async' (history and checkpoints every
    OBS_STRIDE, telemetry every OBS_INTERVAL with a sink, guards
    ``checkpoint_and_raise`` and a flight dir; 'async' with the
    pipeline)."""
    import os

    cfg = sim_tc5_config(root, tag)
    cfg["time"]["nsteps"] = OBS_STRIDE + OBS_STEPS
    if mode == "off":
        cfg["io"] = {}
        return cfg
    cfg["io"].update(history_stride=OBS_STRIDE, checkpoint_stride=OBS_STRIDE,
                     async_pipeline={"enabled": mode == "async"})
    cfg["observability"] = {
        "interval": OBS_INTERVAL, "sink": os.path.join(root, tag, "t.jsonl"),
        "guards": "checkpoint_and_raise",
        "flight_dir": os.path.join(root, tag, "flight"), **obs}
    return cfg


def tree_bytes(root: str) -> dict:
    """Relative path -> bytes of every file under ``root``."""
    import os

    out = {}
    for d, _, names in os.walk(root):
        for f in names:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def same_checkpoints(a, b) -> bool:
    """Two checkpoint managers hold the same steps, each restoring to the
    same time and bitwise the same arrays."""
    import numpy as np

    if a.steps() != b.steps():
        return False
    for s in a.steps():
        (sa, ta), (sb, tb) = a.restore_host(s), b.restore_host(s)
        if ta != tb or sorted(sa) != sorted(sb) or not all(
                np.array_equal(sa[k], sb[k]) for k in sa):
            return False
    return True


def masked_records(path: str) -> list:
    from jaxstream_torch.obs.sink import read_records

    return [{k: v for k, v in r.items() if k not in _VOLATILE}
            for r in read_records(path)]


def sink_wait(path: str, after: int) -> float:
    """The ``host_wait_s`` total of a sink's segments past step
    ``after``."""
    from jaxstream_torch.obs.sink import read_records

    return sum(r.get("host_wait_s", 0.0)
               for r in read_records(path, kind="segment")
               if r["step"] > after)


def io_mode_paths(card: str, root: str) -> dict:
    """Phases 67-68: TC5 C384 through ``Simulation`` with io off, sync and
    async, then the metric stream's cost.  Returns B1's launches."""
    import os

    import numpy as np

    from jaxstream_torch.io.checkpoint import CheckpointManager
    from jaxstream_torch.obs import metrics as obs_metrics
    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.simulation import Simulation
    from jaxstream_torch.utils.diagnostics import total_mass
    from jaxstream_torch.viz.plots import to_latlon

    total = OBS_STRIDE + OBS_STEPS
    half = OBS_STEPS // 2
    b1 = 0
    runs = {}
    # ---- 67. io off, sync, async: windows of half the steps in turns
    # (off, sync, async, async, sync, off), after a warm-up of one stride.
    for mode in ("off", "sync", "async"):
        sim = Simulation(obs_tc5_config(root, mode, mode))
        if sim.stepper_kind != "compact":
            raise RuntimeError(f"{mode}: the {sim.stepper_kind} stepper")
        s0 = {k: v.clone() for k, v in sim.state.items()}
        sim.run(OBS_STRIDE)
        runs[mode] = {"sim": sim, "rates": [], "s0": s0}
    for mode in ("off", "sync", "async", "async", "sync", "off"):
        sim = runs[mode]["sim"]
        torch.cuda.synchronize()
        CovStageCompact.launches = 0
        t0 = time.perf_counter()
        if mode == "off":
            # The strided modes' segmentation, by run() calls.
            for _ in range(half // OBS_STRIDE):
                sim.run(sim.step_count + OBS_STRIDE)
        else:
            sim.run(sim.step_count + half)
        torch.cuda.synchronize()
        runs[mode]["rates"].append(half / (time.perf_counter() - t0))
        b1 += CovStageCompact.launches
        if CovStageCompact.launches != 3 * half:
            raise RuntimeError(f"{mode}: B1 launches "
                               f"{CovStageCompact.launches}")
    for mode, r in runs.items():
        r["sim"].close()
        tc5_gate(f"Simulation io {mode}", r["sim"].grid, r["s0"],
                 r["sim"].state["h"], total * STEP_DT / 86400.0)
        r["rate"] = sum(r["rates"]) / len(r["rates"])
        r["wait"] = (sink_wait(os.path.join(root, mode, "t.jsonl"),
                               OBS_STRIDE) if mode != "off" else 0.0)
    base = runs["off"]["rate"]
    log(f"Simulation TC5 C{N} compact, {OBS_STEPS} timed steps after "
        f"{OBS_STRIDE}, windows of {half} in turns (off, sync, async, "
        "async, sync, off): " + "; ".join(
            f"{m} " + ", ".join(f"{x:.1f}" for x in r["rates"])
            + f" steps/s, mean {r['rate']:.1f} (io overhead "
            f"{100.0 * (base / r['rate'] - 1.0):+.2f}%, host_wait_s "
            f"{r['wait']:.4f} from its sink)" for m, r in runs.items())
        + f"; history and checkpoints every {OBS_STRIDE}, telemetry every "
        f"{OBS_INTERVAL}; B1 launches 3 x {half} a window; card {card}")
    ref = runs["off"]["sim"]
    for mode in ("sync", "async"):
        sim = runs[mode]["sim"]
        bad = [k for k in ref.state
               if not torch.equal(ref.state[k], sim.state[k])]
        if bad:
            raise RuntimeError(f"io {mode}: final state differs from io "
                               f"off in {bad}")
    log("io off, sync and async: final states bitwise equal")
    hs = tree_bytes(os.path.join(root, "sync", "hist"))
    ha = tree_bytes(os.path.join(root, "async", "hist"))
    cs = CheckpointManager(os.path.join(root, "sync", "ckpt"))
    ca = CheckpointManager(os.path.join(root, "async", "ckpt"))
    same_ckpt = same_checkpoints(cs, ca)
    rs = masked_records(os.path.join(root, "sync", "t.jsonl"))
    ra = masked_records(os.path.join(root, "async", "t.jsonl"))
    log(f"sync vs async: history {len(hs)} files, "
        f"{sum(map(len, hs.values())) / 1e6:.1f} MB: "
        + ("byte-equal" if hs == ha else "DIFFER")
        + f"; checkpoints at {cs.steps()}: "
        + ("restored bitwise" if same_ckpt else "DIFFER")
        + f"; sink {len(rs)} records, timing masked: "
        + ("equal" if rs == ra else "DIFFER"))
    if hs != ha or not same_ckpt or rs != ra:
        raise RuntimeError("the async pipeline's outputs differ from sync")
    del hs, ha
    sim = runs["sync"]["sim"]
    # One segment under the sync debug mode: no sample reads back.
    fn = sim._segment_fn(OBS_STRIDE)
    torch.cuda.synchronize()
    CovStageCompact.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        y_seg, _, buf = fn(sim.state, sim.t, sim.step_count)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    b1 += CovStageCompact.launches
    host = obs_metrics.fetch_buffer(buf)
    if not np.all(np.isfinite(host)) or host.shape != (
            sim._obs.ms.k, OBS_STRIDE // OBS_INTERVAL):
        raise RuntimeError("sync-debug segment: bad metric buffer")
    log(f"one {OBS_STRIDE}-step metric segment under "
        "torch.cuda.set_sync_debug_mode('error'): no synchronizing call; "
        f"buffer {host.shape}, finite")
    del y_seg
    h = sim.state["h"]
    ll = to_latlon(h, 181, 360)
    ll_np = to_latlon(h.cpu().numpy(), 181, 360)
    same = ll.device == h.device and np.array_equal(ll.cpu().numpy(), ll_np)
    log(f"to_latlon of the final h on {ll.device}: {tuple(ll.shape)}, "
        + ("bitwise its numpy form" if same else "DIFFERS from numpy"))
    if not same:
        raise RuntimeError("to_latlon on the device differs")

    # ---- 68. the metric stream's cost ----------------------------------
    obs = sim._obs
    y = sim._fused_prep(sim.state)
    mfn = obs.metric_fn
    ev_us = event_ms(lambda: mfn(y, 0.0), SAMPLE_REPS) * 1e3
    graph_us = device_ms(lambda: mfn(y, 0.0)) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SAMPLE_REPS):
        mfn(y, 0.0)
    host_us = (time.perf_counter() - t0) / SAMPLE_REPS * 1e6
    torch.cuda.synchronize()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            mfn(y, 0.0)
        torch.cuda.synchronize()
    kernels = sum(e.count for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA) / 10
    log(f"metric sample C{N} ({obs.ms.k} metrics: {', '.join(obs.ms.names)})"
        f": {ev_us:.1f} us by CUDA events over {SAMPLE_REPS} calls, "
        f"{graph_us:.1f} us of device as a CUDA graph, {host_us:.1f} us of "
        f"host issue per call, {kernels:.0f} kernel launches per sample "
        f"(torch.profiler); card {card}")
    recs = read_records(os.path.join(root, "sync", "t.jsonl"),
                        kind="segment")
    last = recs[-1]
    now = obs.ms.values(sim.state).cpu().numpy()
    eq = all(last["metrics"][n] == float(now[i])
             for i, n in enumerate(obs.ms.names))
    s0 = runs["sync"]["s0"]
    m0, m1 = (float(total_mass(sim.grid, s["h"])) for s in (s0, sim.state))
    d_diag = (m1 - m0) / abs(m0)
    area = sim.grid.interior(sim.grid.area).double()
    g0 = float(torch.sum(area * s0["h"].double()))
    d_gate = (float(torch.sum(area * sim.state["h"].double())) - g0) / g0
    d_sink = last["drift"]["mass"]
    log(f"stream's last sample vs metric_fn on the final state: "
        + ("equal" if eq else "DIFFER") + f"; mass drift: sink "
        f"{d_sink:.6e}, utils.diagnostics {d_diag:.6e}, gate (float64) "
        f"{d_gate:.6e} (|sink - diagnostics| {abs(d_sink - d_diag):.2e}, "
        f"tol {DRIFT_TOL:g})")
    if not eq or abs(d_sink - d_diag) > DRIFT_TOL:
        raise RuntimeError("the metric stream disagrees with the state")
    runs.clear()
    del sim, ref, y
    # Steps/s with metrics on and off, in turns (no io: one segment per
    # window).
    sims = {}
    for name, interval in (("on", OBS_INTERVAL), ("off", 0)):
        cfg = obs_tc5_config(root, f"rate_{name}", "off")
        cfg["observability"] = {"interval": interval}
        sims[name] = Simulation(cfg)
        sims[name].run(WARM_STEPS)
    rates = {"on": [], "off": []}
    window = OBS_STEPS // 4
    CovStageCompact.launches = 0
    for name in ("on", "off", "off", "on"):
        sim = sims[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(sim.step_count + window)
        torch.cuda.synchronize()
        rates[name].append(window / (time.perf_counter() - t0))
    b1 += CovStageCompact.launches
    if CovStageCompact.launches != 12 * window:
        raise RuntimeError("metrics on/off: B1 launches")
    bad = [k for k in sims["on"].state if not torch.equal(
        sims["on"].state[k], sims["off"].state[k])]
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"metrics every {OBS_INTERVAL} steps on vs off, {window}-step "
        "windows in turns (on, off, off, on): on "
        + ", ".join(f"{r:.1f}" for r in rates["on"]) + " steps/s; off "
        + ", ".join(f"{r:.1f}" for r in rates["off"]) + " steps/s; cost "
        f"{100.0 * (mean['off'] / mean['on'] - 1.0):+.2f}% of wall; "
        f"states after {WARM_STEPS + 2 * window} steps "
        + ("bitwise equal" if not bad else f"DIFFER in {bad}")
        + f"; card {card}")
    if bad:
        raise RuntimeError("metrics on perturbed the carry")
    return {"cov_stage_compact": b1}


def guard_path(card: str, root: str) -> dict:
    """Phase 69: a fault on a sampled step raises HealthError; the guard
    record, the postmortem checkpoint, the flight bundle (read by the
    port and by scripts/postmortem.py); a new Simulation on the same
    directories resumes and ends bitwise equal to the uninterrupted
    run."""
    import os

    from jaxstream_torch.io.checkpoint import CheckpointManager
    from jaxstream_torch.obs import flight
    from jaxstream_torch.obs.monitor import HealthError
    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.simulation import Simulation

    def cfg(tag, sink, **obs):
        c = obs_tc5_config(root, tag, "sync", **obs)
        c["time"]["nsteps"] = GUARD_STEPS
        c["observability"]["sink"] = os.path.join(root, tag, sink)
        return c

    here = os.path.dirname(os.path.abspath(__file__))
    CovStageCompact.launches = 0
    sim = Simulation(cfg("guard", "a.jsonl", fault_step=GUARD_FAULT))
    try:
        sim.run()
    except HealthError as e:
        err = e
    else:
        raise RuntimeError("the injected fault did not raise HealthError")
    finally:
        sim.close()
    want_good = GUARD_FAULT - OBS_INTERVAL
    recs = read_records(os.path.join(root, "guard", "a.jsonl"))
    kinds = [r["kind"] for r in recs]
    guards = [r for r in recs if r["kind"] == "guard"]
    cm = CheckpointManager(os.path.join(root, "guard", "ckpt"))
    post = cm.latest_step()
    meta = cm.restore_meta(post)
    bdir = flight.latest_bundle(os.path.join(root, "guard", "flight"))
    manifest, events = flight.read_bundle(bdir)
    pm = subprocess.run([sys.executable, os.path.join(here, "scripts",
                                                      "postmortem.py"),
                         bdir, "--sink", os.path.join(root, "guard",
                                                      "a.jsonl")],
                        capture_output=True, text=True, timeout=120)
    log(f"guard: {err}; guard records {[(g['step'], g['last_good_step']) for g in guards]}"
        f", sink kinds after the last segment {kinds[-3:]}; checkpoints "
        f"{cm.steps()}, the postmortem at {post} (meta {meta}); bundle "
        f"{manifest['bundle_id']} ({manifest['n_events']} events, reason "
        f"{manifest['reason']}); scripts/postmortem.py exit "
        f"{pm.returncode}")
    ok = (err.kind == "nan" and err.step == GUARD_FAULT
          and err.last_good_step == want_good
          and [g["step"] for g in guards] == [GUARD_FAULT]
          and kinds[-3:] == ["guard", "flight", "crash"]
          and meta.get("postmortem") == 1
          and any(s <= want_good for s in cm.steps())
          and pm.returncode == 0 and manifest["bundle_id"] in pm.stdout)
    if not ok:
        log(pm.stdout[-2000:] + pm.stderr[-2000:])
        raise RuntimeError("guard phase: evidence missing")
    resumed = Simulation(cfg("guard", "b.jsonl"))
    start = resumed.step_count
    resumed.run()
    resumed.close()
    stamp_rec = read_records(os.path.join(root, "guard", "b.jsonl"),
                             kind="resume")
    ref = Simulation(cfg("guard_ref", "r.jsonl"))
    ref.run()
    ref.close()
    bad = [k for k in ref.state
           if not torch.equal(ref.state[k], resumed.state[k])]
    log(f"resumed at step {start} with lineage {stamp_rec}; after "
        f"{GUARD_STEPS} steps vs the uninterrupted run: "
        + ("bitwise equal" if not bad and ref.t == resumed.t
           else f"DIFFERS in {bad}, t {resumed.t} vs {ref.t}"))
    if (bad or ref.t != resumed.t or not stamp_rec
            or stamp_rec[0]["bundle"] != manifest["bundle_id"]):
        raise RuntimeError("the resumed run differs or lost its lineage")
    return {"cov_stage_compact": CovStageCompact.launches}


def galewsky_day6_simulation(card: str, gal: "Galewsky") -> tuple:
    """Phases 8 and 70: the Galewsky YAML (split, its io block off) to day
    6 through ``Simulation`` with telemetry every GAL_OBS_INTERVAL steps,
    guards 'warn' and the covariant ladder; the day-6 gate, the launches,
    the sink's mass drift against the gate's.  The jet's CFL number in
    the ladder's convention (both directions summed) passes the default
    limit of 2 at dt = 60 s, so 'warn' records CFL events; any other event
    fails the phase.  Returns the (B1, B2) launches and the day-6 compact
    carry and time (phase 9's start)."""
    import dataclasses
    import logging
    import os
    import shutil
    import tempfile

    from jaxstream_torch.config import load_config
    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import (CovNu4Filter,
                                                  CovStageCompact)
    from jaxstream_torch.simulation import Simulation

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_",
                            dir=os.path.join(here, "build"))
    try:
        cfg = load_config(os.path.join(here, SIM_GAL_CONFIG))
        sink = os.path.join(root, "t.jsonl")
        cfg = dataclasses.replace(
            cfg, io=dataclasses.replace(cfg.io, history_stride=0,
                                        checkpoint_stride=0),
            observability=dataclasses.replace(
                cfg.observability, interval=GAL_OBS_INTERVAL, sink=sink,
                guards="warn"))
        sim = Simulation(cfg)
        if sim.stepper_kind != "compact" or sim.model.nu4 != GAL_NU4:
            raise RuntimeError("Galewsky config: not the split stepper")
        if "enstrophy" not in sim._obs.ms.names:
            raise RuntimeError("the covariant ladder lacks enstrophy")
        # Under 'warn' the monitor logs each breach; the count is logged.
        quiet = logging.getLogger("jaxstream_torch.obs.monitor")
        level = quiet.level
        quiet.setLevel(logging.ERROR)
        CovStageCompact.launches = CovNu4Filter.launches = 0
        t0 = time.perf_counter()
        try:
            sim.run(GAL_DAY6_STEPS)
        finally:
            quiet.setLevel(level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        sim.close()
        launches = (CovStageCompact.launches, CovNu4Filter.launches)
        if launches != (3 * GAL_DAY6_STEPS, GAL_DAY6_STEPS):
            raise RuntimeError(f"launches (stage, filter) {launches} != "
                               f"(3 x, 1 x) {GAL_DAY6_STEPS} steps")
        last = read_records(sink, kind="segment")[-1]
        guards = read_records(sink, kind="guard")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    d_gate = gal.drift(sim.state["h"])
    events = sorted({g["event"] for g in guards})
    gal.gate("split, Simulation with telemetry", sim.state, sim.t,
             f"launches stage {launches[0]} = 3 x {GAL_DAY6_STEPS}, filter "
             f"{launches[1]} = {GAL_DAY6_STEPS}; {GAL_DAY6_STEPS} steps in "
             f"{wall:.2f} s; sink mass drift {last['drift']['mass']:.6e}, "
             f"{len(guards)} guard events {events} (policy warn)")
    log(f"Galewsky C{N} day 6 through Simulation ({SIM_GAL_CONFIG}, io "
        f"off), telemetry every {GAL_OBS_INTERVAL}: "
        f"{GAL_DAY6_STEPS / wall:.1f} steps/s; last sample "
        f"{last['metrics']}; |sink drift| {abs(last['drift']['mass']):.6e}"
        f" vs the gate's {d_gate:.6e} (tol {DRIFT_TOL:g}); card {card}")
    if (any(g["event"] != "cfl" for g in guards)
            or abs(abs(last["drift"]["mass"]) - d_gate) > DRIFT_TOL):
        raise RuntimeError("Galewsky telemetry disagrees with its gate")
    return launches, gal.model.compact_state(sim.state), sim.t


def ensemble_telemetry(card: str, root: str) -> dict:
    """Phase 71: the TC5 ensemble at B = ENS_OBS_MEMBERS with telemetry:
    member rows and spread in the sink, member-steps/s with metrics on
    and off in turns, every member under TC5's gate."""
    import os

    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.simulation import Simulation

    B = ENS_OBS_MEMBERS
    sims = {}
    for name, interval in (("on", OBS_INTERVAL), ("off", 0)):
        cfg = obs_tc5_config(root, f"ens_{name}", "off")
        cfg["ensemble"] = {"members": B, "seed": 0, "amplitude": 1e-3}
        cfg["observability"] = {
            "interval": interval, "guards": "warn",
            "sink": os.path.join(root, f"ens_{name}.jsonl"),
            "metrics": "mass,energy,h_min,h_max,h_spread,ens_mean_drift,"
                       "nonfinite_count"}
        sims[name] = Simulation(cfg)
        if sims[name].stepper_kind != "compact":
            raise RuntimeError("ensemble: not the batched fused stepper")
    s0 = {k: v.clone() for k, v in sims["on"].state.items()}
    for sim in sims.values():
        sim.run(WARM_STEPS)
    rates = {"on": [], "off": []}
    CovStageCompact.launches = 0
    for name in ("on", "off", "off", "on"):
        sim = sims[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(sim.step_count + ENS_OBS_WINDOW)
        torch.cuda.synchronize()
        rates[name].append(B * ENS_OBS_WINDOW / (time.perf_counter() - t0))
    launches = CovStageCompact.launches
    on = sims["on"]
    on.close()
    names = on._obs.ms.names
    recs = read_records(os.path.join(root, "ens_on.jsonl"), kind="segment")
    last = recs[-1]["metrics"]
    rows = [n for n in names if n.startswith("nonfinite_m")]
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"ensemble B={B} C{N} TC5 with telemetry every {OBS_INTERVAL}: "
        f"member rows {len(rows)}, h_spread {last['h_spread']:.4e}, "
        f"ens_mean_drift {last['ens_mean_drift']:.4e}, non-finite "
        f"{sum(last[n] for n in rows):g}; member-steps/s in turns (on, "
        "off, off, on), windows of " f"{ENS_OBS_WINDOW}: on "
        + ", ".join(f"{r:.1f}" for r in rates["on"]) + "; off "
        + ", ".join(f"{r:.1f}" for r in rates["off"]) + f"; cost "
        f"{100.0 * (mean['off'] / mean['on'] - 1.0):+.2f}%; B1 members "
        f"launches {launches}; card {card}")
    if (len(rows) != B or not last["h_spread"] > 0.0
            or launches != 12 * ENS_OBS_WINDOW
            or any(last[n] != 0.0 for n in rows)
            or on._obs.monitor.events):
        raise RuntimeError("ensemble telemetry")
    days = (WARM_STEPS + 2 * ENS_OBS_WINDOW) * STEP_DT / 86400.0
    for i in range(B):
        tc5_gate(f"ensemble with telemetry, member {i}", on.grid,
                 {"h": s0["h"][i]}, on.state["h"][i], days)
    return {"cov_stage_members mc f32": launches}


def face_telemetry(card: str, root: str) -> dict:
    """Phase 72: the face tier on six virtual ranks with telemetry: its
    samples against the single-device classic run's (the tier's float32
    budgets, phase 45's)."""
    import os

    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import CovRhs
    from jaxstream_torch.simulation import Simulation

    out = {}
    CovRhs.launches = 0
    for name, par in (("face", {"num_devices": 6, "use_shard_map": True}),
                      ("single", {})):
        cfg = sim_tc5_config(root, f"obs_{name}", backend="jnp")
        cfg["io"] = {}
        cfg["time"]["nsteps"] = FACE_OBS_STEPS
        cfg["parallelization"].update(par)
        cfg["observability"] = {
            "interval": OBS_INTERVAL,
            "sink": os.path.join(root, f"obs_{name}.jsonl")}
        sim = Simulation(cfg)
        sim.run()
        sim.close()
        out[name] = read_records(os.path.join(root, f"obs_{name}.jsonl"),
                                 kind="segment")[-1]
    launches = CovRhs.launches
    f, s = out["face"], out["single"]
    errs = {n: abs(f["metrics"][n] - v) / max(abs(v), 1e-30)
            for n, v in s["metrics"].items()}
    tol = {n: TIER_MASS_TOL if n == "mass" else TIER_VS_CLASSIC_TOL
           for n in errs}
    log(f"face tier (6 virtual ranks) telemetry, {FACE_OBS_STEPS} steps, "
        f"samples at {f['samples']['step']}: rel diff vs the single-device "
        "run " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items())
        + f" (tol mass {TIER_MASS_TOL:g}, else {TIER_VS_CLASSIC_TOL:g}); "
        f"B4 stacked launches {launches} (want {3 * FACE_OBS_STEPS})")
    if (any(e > tol[n] for n, e in errs.items())
            or launches != 3 * FACE_OBS_STEPS
            or f["samples"]["step"] != s["samples"]["step"]):
        raise RuntimeError("face tier telemetry")
    return {"cov_rhs": launches}


def lazy_paths(card: str, root: str) -> dict:
    """Phase 73: ``grid.metrics: lazy``, TC5 C384: the compact path
    against the eager one in turns (the gate, the distance), and the
    classic path's cost per step."""
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.simulation import Simulation

    sims = {}
    for metrics in ("lazy", "eager"):
        cfg = obs_tc5_config(root, f"lazy_{metrics}", "off")
        cfg["grid"]["metrics"] = metrics
        sims[metrics] = Simulation(cfg)
        if sims[metrics].stepper_kind != "compact":
            raise RuntimeError("lazy: not the compact stepper")
    s0 = {k: v.clone() for k, v in sims["lazy"].state.items()}
    init = {k: rel_err(sims["eager"].state[k], v) for k, v in s0.items()}
    for sim in sims.values():
        sim.run(WARM_STEPS)
    rates = {"lazy": [], "eager": []}
    CovStageCompact.launches = 0
    for name in ("lazy", "eager", "eager", "lazy"):
        sim = sims[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(sim.step_count + LAZY_WINDOW)
        torch.cuda.synchronize()
        rates[name].append(LAZY_WINDOW / (time.perf_counter() - t0))
    launches = CovStageCompact.launches
    steps = WARM_STEPS + 2 * LAZY_WINDOW
    lz = sims["lazy"]
    tc5_gate("Simulation lazy metrics", lz.grid, s0, lz.state["h"],
             steps * STEP_DT / 86400.0)
    dist = {k: rel_err(sims["eager"].state[k], lz.state[k])
            for k in ("h", "u")}
    log(f"lazy vs eager metrics, compact TC5 C{N}: initial state rel diff "
        f"h {init['h']:.3e}, u {init['u']:.3e}; after {steps} steps h "
        f"{dist['h']:.3e}, u {dist['u']:.3e}; steps/s in turns (lazy, "
        "eager, eager, lazy), windows of " f"{LAZY_WINDOW}: lazy "
        + ", ".join(f"{r:.1f}" for r in rates["lazy"]) + "; eager "
        + ", ".join(f"{r:.1f}" for r in rates["eager"])
        + f"; B1 launches {launches}; card {card}")
    if launches != 12 * LAZY_WINDOW:
        raise RuntimeError("lazy: B1 launches")
    sims.clear()
    del lz
    # The classic path recomputes the lazy metric expressions every rhs.
    walls = {"lazy": [], "eager": []}
    classic = {}
    for metrics in ("lazy", "eager"):
        cfg = sim_tc5_config(root, f"lazyc_{metrics}", backend="jnp")
        cfg["io"] = {}
        cfg["grid"]["metrics"] = metrics
        classic[metrics] = Simulation(cfg)
        classic[metrics].run(1)
    for name in ("lazy", "eager", "eager", "lazy"):
        sim = classic[name]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run(sim.step_count + LAZY_CLASSIC_STEPS)
        torch.cuda.synchronize()
        walls[name].append((time.perf_counter() - t0) / LAZY_CLASSIC_STEPS)
    mean = {k: sum(v) / len(v) * 1e3 for k, v in walls.items()}
    log(f"classic TC5 C{N} (backend jnp) ms per step in turns (lazy, "
        "eager, eager, lazy): lazy " + ", ".join(
            f"{w * 1e3:.2f}" for w in walls["lazy"]) + "; eager "
        + ", ".join(f"{w * 1e3:.2f}" for w in walls["eager"])
        + f"; lazy costs {mean['lazy'] / mean['eager']:.2f}x eager; "
        f"card {card}")
    return {"cov_stage_compact": launches}


def flight_overhead(card: str) -> None:
    """Phase 74: the flight recorder on against ``flight.disabled()``,
    paired windows in alternating order, the quietest ratio (as
    ``bench.py::bench_flight_overhead``): FLIGHT_WINDOWS segments of
    FLIGHT_K compact TC5 steps, each closed by the loop's two records."""
    from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA, EARTH_RADIUS
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.obs import flight
    from jaxstream_torch.physics.initial_conditions import williamson_tc5
    from jaxstream_torch.stepping import integrate

    grid = build_grid(N, halo=2, radius=EARTH_RADIUS, dtype=torch.float32)
    h_ext, v_ext, b_ext = williamson_tc5(grid, EARTH_GRAVITY, EARTH_OMEGA)
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext)
    step = model.make_fused_step(STEP_DT)
    y0 = model.compact_state(model.initial_state(h_ext, v_ext))

    def window():
        y, t = y0, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for w in range(FLIGHT_WINDOWS):
            y, t = integrate(step, y, t, FLIGHT_K, STEP_DT)
            flight.record("segment", step=(w + 1) * FLIGHT_K, k=FLIGHT_K)
            flight.record("checkpoint", step=(w + 1) * FLIGHT_K)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window()
    with flight.disabled():
        window()
    ratios, ons, offs = [], [], []
    for i in range(FLIGHT_REPEATS):
        if i % 2 == 0:
            on = window()
            with flight.disabled():
                off = window()
        else:
            with flight.disabled():
                off = window()
            on = window()
        ons.append(on)
        offs.append(off)
        ratios.append(on / off)
    overhead = (min(ratios) - 1.0) * 100.0
    # The records' own cost, apart from the host's drift between windows.
    rec = flight.FlightRecorder()
    reps = 100_000
    t0 = time.perf_counter()
    for i in range(reps):
        rec.record("segment", step=i, k=FLIGHT_K)
    per_us = (time.perf_counter() - t0) / reps * 1e6
    share = 2 * FLIGHT_WINDOWS * per_us * 1e-6 / min(offs) * 100.0
    log(f"flight recorder on vs off: {FLIGHT_WINDOWS} segments of "
        f"{FLIGHT_K} compact TC5 C{N} steps per window, {FLIGHT_REPEATS} "
        f"pairs in alternating order: best on {min(ons) * 1e3:.3f} ms, off "
        f"{min(offs) * 1e3:.3f} ms; quietest ratio {min(ratios):.5f} -> "
        f"overhead {overhead:+.3f}% (median ratio "
        f"{sorted(ratios)[len(ratios) // 2]:.5f}); one record "
        f"{per_us:.3f} us of host ({reps} records), "
        f"{2 * FLIGHT_WINDOWS} a window = {share:.4f}% of the off window; "
        f"card {card}")


def telemetry_paths(card: str, t_start: float) -> dict:
    """Phases 67-74 (see the module docstring); their io in a directory
    of the checkout's ``build/``.  Returns each kernel record's launches
    on these paths, by record name."""
    import os
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_obs_",
                            dir=os.path.join(here, "build"))
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    try:
        stamp(t_start, "Simulation io off / sync / async, the metric "
              "stream (phases 67-68)")
        add(io_mode_paths(card, root))
        stamp(t_start, "guards, flight bundle, resume (phase 69)")
        add(guard_path(card, root))
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        stamp(t_start, "ensemble with telemetry (phase 71)")
        add(ensemble_telemetry(card, root))
        stamp(t_start, "face tier with telemetry (phase 72)")
        add(face_telemetry(card, root))
        stamp(t_start, "lazy metrics (phase 73)")
        add(lazy_paths(card, root))
        stamp(t_start, "flight recorder overhead (phase 74)")
        flight_overhead(card)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"launches on the telemetry paths (phases 67-73): {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phases 75-78: the serving stack (EnsembleServer, Gateway, load harness)
# ---------------------------------------------------------------------------

#: bench_serving's ragged ladder: 48 requests with distinct seeds, their
#: lengths cycling through SERVE_LENGTHS.
SERVE_REQUESTS = 48
SERVE_LENGTHS = (24, 43, 17, 56, 37)
SERVE_SEGMENT = 8
SERVE_PACKED = 16
#: Segments per window of the masked-vs-bare stepper comparison.
SERVE_TIMED_SEGMENTS = 12
#: Requests of phase 75 checked bitwise against their solo runs.
SERVE_SOLO = (0, 7, 30)
#: Phase 76: one request of each family, 3-5 steps.
SERVE_MIXED = (("m-tc2", "tc2", 3), ("m-tc5", "tc5", 5),
               ("m-tc6", "tc6", 4), ("m-gal", "galewsky", 5))
#: Phase 78: bench_serving_slo's arrival trace, sized to the budget.
SLO_REQUESTS = 32
SLO_SEED = 1404
SLO_LENGTHS = (16, 25, 8, 43)


def serve_config(**serve) -> dict:
    """The serving deployment of phases 75-78: C384 TC5 physics, dt = 75
    s, backend pallas, one device."""
    s = {"buckets": f"1,{SERVE_PACKED}", "segment_steps": SERVE_SEGMENT,
         "queue_capacity": 64, "group_by_orography": True}
    s.update(serve)
    return {"grid": {"n": N, "halo": 2}, "time": {"dt": STEP_DT},
            "model": {"name": "shallow_water_cov", "backend": "pallas",
                      "initial_condition": "tc5"},
            "parallelization": {"num_devices": 1},
            "serve": s}


def serve_ladder(tag: str, outputs_uh=SERVE_SOLO):
    """The ragged ladder's requests (ids prefixed ``tag``)."""
    from jaxstream_torch.serve import ScenarioRequest

    return [ScenarioRequest(
        id=f"{tag}{i}", ic="tc5",
        nsteps=SERVE_LENGTHS[i % len(SERVE_LENGTHS)], seed=i,
        amplitude=1e-3,
        outputs=("h", "u") if i in outputs_uh else ("h",))
        for i in range(SERVE_REQUESTS)]


def served_run(srv, reqs) -> tuple:
    """Admit ``reqs``, then drain them in a timed window (as
    ``bench.py::bench_serving`` times ``serve()``); returns (wall seconds,
    results, the stats' deltas)."""
    before = dict(srv.stats)
    srv.results.clear()
    for r in reqs:
        srv.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    srv.serve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    delta = {k: srv.stats[k] - before[k] for k in srv.stats
             if isinstance(srv.stats[k], (int, float))}
    return wall, dict(srv.results), delta


def sync_free_segment(srv, bk, label: str) -> None:
    """One masked segment of bucket ``bk`` and the start of its health
    fetch under ``torch.cuda.set_sync_debug_mode("error")``: nothing
    inside a segment synchronizes."""
    import numpy as np

    st = srv._warm_member_tree(bk.group)
    carry = bk.stack([st] * bk.B)
    rem = np.full(bk.B, SERVE_SEGMENT)
    rem[0] = 3
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry, _, nf = bk.seg(carry, bk.put_rem(rem))
        fetch = srv._fetch(nf)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    bad = fetch.resolve()
    log(f"{label}: one segment ({SERVE_SEGMENT} steps, B={bk.B}, "
        f"{bk.impl}) under sync debug mode 'error': no sync; non-finite "
        f"{bad.tolist()}")
    if bad.any():
        raise RuntimeError(f"{label}: non-finite members")


def serving_grouped(card: str) -> tuple:
    """Phase 75: grouped TC5 serving at C384 on B1 (B = 1) and B1's
    member fold (B = 16), against the static B = 16 ensemble stepper.
    Returns (launch counts by record name, the packed member-steps/s)."""
    import math

    import numpy as np

    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.serve import EnsembleServer, ScenarioRequest
    from jaxstream_torch.simulation import Simulation
    from jaxstream_torch.stepping import integrate

    t0 = time.perf_counter()
    srv = EnsembleServer(serve_config())
    warm = srv.warmup(groups=("oro",))
    log(f"phase 75 setup: C{N} server, buckets {list(srv.buckets)} warm "
        f"({srv.bucket_impls()}) in {time.perf_counter() - t0:.2f} s; "
        f"compile_count {warm}")
    for B in srv.buckets:
        sync_free_segment(srv, srv._buckets[("oro", B)],
                          f"serving B={B}")
    model = srv._model("oro")
    total = sum(r.nsteps for r in serve_ladder("x"))
    static_steps = math.ceil(total / SERVE_PACKED)
    members = [srv._request_state(r) for r in serve_ladder("s")
               [:SERVE_PACKED]]
    y16 = model.ensemble_compact_state(model.stack_ensemble(members))
    step16 = model.make_fused_step(STEP_DT, ensemble=SERVE_PACKED)
    integrate(step16, y16, 0.0, 2, STEP_DT)
    rates = {"packed": [], "serial": [], "static": []}
    counts = {"cov_stage_compact": 0, "cov_stage_members mc f32": 0}
    runs = {}
    for turn, mode in enumerate(("packed", "static", "serial", "static",
                                 "packed")):
        if mode == "static":
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            integrate(step16, y16, 0.0, static_steps, STEP_DT)
            torch.cuda.synchronize()
            rates[mode].append(SERVE_PACKED * static_steps
                               / (time.perf_counter() - t1))
            continue
        srv.resize(SERVE_PACKED if mode == "packed" else 1)
        CovStageCompact.launches = 0
        wall, res, delta = served_run(srv, serve_ladder(f"{mode}{turn}-"))
        counts["cov_stage_members mc f32" if mode == "packed"
               else "cov_stage_compact"] += CovStageCompact.launches
        if CovStageCompact.launches != 3 * SERVE_SEGMENT * delta["segments"]:
            raise RuntimeError(f"serving {mode}: stage launches "
                               f"{CovStageCompact.launches} != 3 x "
                               f"{SERVE_SEGMENT} x {delta['segments']}")
        if delta["member_steps"] != total or any(
                r.status != "ok" for r in res.values()) or len(res) != \
                SERVE_REQUESTS:
            raise RuntimeError(f"serving {mode}: not every request ok, or "
                               f"member-steps {delta['member_steps']} != "
                               f"{total}")
        rates[mode].append(total / wall)
        lat = np.sort([r.latency_s for r in res.values()])
        log(f"serving {mode} (cap {srv._active_max}), turn {turn}: "
            f"{SERVE_REQUESTS} requests, {total} member-steps in "
            f"{wall:.3f} s -> {total / wall:.1f} member-steps/s; segments "
            f"{delta['segments']}, occupancy "
            f"{delta['occupancy_sum'] / delta['segments']:.4f}, "
            f"utilization {delta['utilization_sum'] / delta['segments']:.4f}"
            f", latency p50 {np.percentile(lat, 50):.4f} s p99 "
            f"{np.percentile(lat, 99):.4f} s, host_wait_s "
            f"{delta['host_wait_s']:.4f}, host per boundary "
            f"{1e6 * delta['boundary_s'] / delta['segments']:.1f} us; "
            f"stage launches {CovStageCompact.launches}; card {card}")
        runs[mode] = res
    if srv.compile_count() != warm:
        raise RuntimeError(f"serving built after warm-up: compile_count "
                           f"{srv.compile_count()} != {warm}")
    # Every request bitwise across the two packings, and three of them
    # bitwise their solo runs on the unbatched fused stepper.
    for i in range(SERVE_REQUESTS):
        a, b = runs["packed"][f"packed4-{i}"], runs["serial"][f"serial2-{i}"]
        for k in a.fields:
            if a.fields[k].tobytes() != b.fields[k].tobytes():
                raise RuntimeError(f"request {i} {k}: packed != serial")
    step1 = model.make_fused_step(STEP_DT)
    for i in SERVE_SOLO:
        req = serve_ladder("solo")[i]
        y = model.compact_state(srv._request_state(req))
        y, _ = integrate(step1, y, 0.0, req.nsteps, STEP_DT)
        got = runs["packed"][f"packed4-{i}"].fields
        for k in ("h", "u"):
            if got[k].tobytes() != y[k].cpu().numpy().tobytes():
                raise RuntimeError(f"packed request {i} {k} differs from "
                                   "its solo run")
    # Where a served step's time goes: the bucket's masked segments
    # (every slot active) against the bare stepper, in turns, and one
    # request's state build on the host.
    seg_us = {}
    for label, B, bare, yb in (("B=1", 1, step1, model.compact_state(
            members[0])), (f"B={SERVE_PACKED}", SERVE_PACKED, step16, y16)):
        bk = srv._buckets[("oro", B)]
        carry = bk.stack(members[:B])
        rem = np.full(B, 10 ** 6)
        for mode in ("masked", "bare", "bare", "masked"):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for _ in range(SERVE_TIMED_SEGMENTS):
                if mode == "masked":
                    bk.seg(carry, bk.put_rem(rem))
                else:
                    integrate(bare, yb, 0.0, SERVE_SEGMENT, STEP_DT)
            torch.cuda.synchronize()
            seg_us.setdefault((label, mode), []).append(
                1e6 * (time.perf_counter() - t1)
                / (SERVE_TIMED_SEGMENTS * SERVE_SEGMENT))
    t1 = time.perf_counter()
    for r in serve_ladder("build")[:4]:
        srv._member_tree(r)
    torch.cuda.synchronize()
    build_ms = 1e3 * (time.perf_counter() - t1) / 4
    log("serving step, us of wall per step over "
        f"{SERVE_TIMED_SEGMENTS} segments of {SERVE_SEGMENT} (masked, "
        "bare, bare, masked): " + "; ".join(
            f"{lab} {mode} " + ", ".join(f"{v:.1f}" for v in vals)
            for (lab, mode), vals in seg_us.items())
        + f"; one request's state build on the host {build_ms:.2f} ms; "
        f"card {card}")
    sim_steps = SERVE_LENGTHS[2]
    srv.resize(1)
    srv.results.clear()
    srv.submit(ScenarioRequest(id="sim", ic="tc5", nsteps=sim_steps,
                               seed=-1, outputs=("h", "u")))
    srv.serve()
    cfg = serve_config()
    cfg["time"]["nsteps"] = sim_steps
    sim = Simulation(cfg)
    sim.run()
    for k in ("h", "u"):
        if srv.results["sim"].fields[k].tobytes() != \
                sim.state[k].cpu().numpy().tobytes():
            raise RuntimeError(f"B=1 request {k} differs from Simulation")
    mean = {k: sum(v) / len(v) for k, v in rates.items()}
    log(f"serving C{N} TC5 dt={STEP_DT:g} (ragged ladder {SERVE_LENGTHS}, "
        f"{SERVE_REQUESTS} requests): member-steps/s packed B={SERVE_PACKED}"
        f" {', '.join(f'{r:.1f}' for r in rates['packed'])}, serial B=1 "
        f"{', '.join(f'{r:.1f}' for r in rates['serial'])}, static B="
        f"{SERVE_PACKED} ensemble stepper "
        f"{', '.join(f'{r:.1f}' for r in rates['static'])}; packed / static"
        f" {mean['packed'] / mean['static']:.3f} (the JAX package's floor "
        f"0.9), packed / serial {mean['packed'] / mean['serial']:.3f}; "
        f"every request bitwise packed vs serial, requests {SERVE_SOLO} "
        f"bitwise their solo runs, B=1 bitwise Simulation; compile_count "
        f"{warm} after warm-up and after serving; card {card}")
    srv.close()
    return counts, mean["packed"]


def serving_mixed(card: str) -> dict:
    """Phase 76: a mixed-orography batch on B4 (the classic SSPRK3, each
    member's own orography).  Returns B4's launches."""
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda.swe_cov import CovRhs
    from jaxstream_torch.serve import EnsembleServer, ScenarioRequest
    from jaxstream_torch.stepping import integrate

    srv = EnsembleServer(serve_config(buckets="4",
                                      group_by_orography=False))
    srv.warmup()
    for _, ic, _ in SERVE_MIXED:          # the families' base fields
        srv._ic(ic)
    sync_free_segment(srv, srv._buckets[("any", 4)], "serving mixed B=4")
    reqs = [ScenarioRequest(id=rid, ic=ic, nsteps=ns, seed=-1,
                            outputs=("h", "u"))
            for rid, ic, ns in SERVE_MIXED]
    CovRhs.launches = 0
    wall, res, delta = served_run(srv, reqs)
    launches = CovRhs.launches
    iters = SERVE_SEGMENT * delta["segments"]
    if delta["batches"] != 1 or launches != 3 * 4 * iters:
        raise RuntimeError(f"mixed batch: batches {delta['batches']}, B4 "
                           f"launches {launches} != 3 x 4 x {iters}")
    m = srv._model("any")
    p = srv.config.physics
    for rid, ic, ns in SERVE_MIXED:
        b = srv._ic("tc5")[2] if ic == "tc5" else None
        baked = CovariantShallowWater(srv.grid, gravity=p.gravity,
                                      omega=p.omega, b_ext=b,
                                      backend="pallas")
        y = srv._request_state(ScenarioRequest(id=rid, ic=ic, nsteps=ns))
        y, _ = integrate(baked.make_step(STEP_DT), y, 0.0, ns, STEP_DT)
        for k in ("h", "u"):
            if res[rid].fields[k].tobytes() != y[k].cpu().numpy().tobytes():
                raise RuntimeError(f"mixed request {rid} {k} differs from "
                                   "its baked-static solo run")
    kern = m._pallas_rhs.kernel
    y = srv._request_state(reqs[1])
    h_ext, u_ext = m.fill(y["h"]), m._fill_u(y["u"])
    max_abs = 0.0
    for fam in ("tc5", "tc2"):
        args = (kern.fz[:, None], h_ext, u_ext, srv._b_ext(fam)) \
            + m._pallas_rhs.sym(u_ext)
        max_abs = max(max_abs, check_bitwise(
            f"B4 vs plain C{N}, per-member orography "
            f"({'mountain' if fam == 'tc5' else 'zeros'})", kern,
            kern.reference, args, ("dh", "du"), lambda: CovRhs.launches))
    member_steps = delta["member_steps"]
    log(f"serving mixed C{N} (tc2, tc5, tc6, galewsky, one batch of 4): "
        f"{member_steps} member-steps in {wall:.3f} s, "
        f"{1e3 * wall / member_steps:.2f} ms per member-step; B4 launches "
        f"{launches} = 3 per member per iteration x 4 members x {iters} "
        f"iterations, {launches / member_steps:.2f} per advanced "
        f"member-step; each result bitwise its baked-static solo run; "
        f"card {card}")
    srv.close()
    return {"cov_rhs": launches}


def serving_guards(card: str, root: str) -> dict:
    """Phase 77: eviction keeps the batch bitwise; halt puts the popped
    refill back and the crash bundle names the open requests.  Returns
    the stage launches by record name."""
    import os

    from jaxstream_torch.obs import flight
    from jaxstream_torch.obs.monitor import HealthError
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.serve import EnsembleServer, ScenarioRequest
    from jaxstream_torch.stepping import integrate

    cfg = serve_config(buckets="4", fault_member=1)
    cfg["observability"] = {"fault_step": SERVE_SEGMENT}
    srv = EnsembleServer(cfg)
    srv.warmup(groups=("oro",))
    reqs = [ScenarioRequest(id=f"e{i}", ic="tc5", nsteps=ns, seed=i,
                            outputs=("h", "u"))
            for i, ns in enumerate((2 * SERVE_SEGMENT, 2 * SERVE_SEGMENT,
                                    SERVE_SEGMENT + 3))]
    CovStageCompact.launches = 0
    _, res, _ = served_run(srv, reqs)
    members = CovStageCompact.launches
    if res["e1"].status != "evicted" or res["e1"].guard_event[
            "member"] != 1:
        raise RuntimeError("evict: member 1 not evicted")
    m = srv._model("oro")
    step1 = m.make_fused_step(STEP_DT)
    for r in (reqs[0], reqs[2]):
        y, _ = integrate(step1, m.compact_state(srv._request_state(r)),
                         0.0, r.nsteps, STEP_DT)
        for k in ("h", "u"):
            if res[r.id].fields[k].tobytes() != y[k].cpu().numpy().tobytes():
                raise RuntimeError(f"evict: {r.id} {k} differs from its "
                                   "solo run")
    srv.close()

    fdir = os.path.join(root, "serve_flight")
    cfg = serve_config(buckets="2", guards="halt", fault_member=0)
    cfg["observability"] = {"fault_step": SERVE_SEGMENT,
                            "flight_dir": fdir}
    srv = EnsembleServer(cfg)
    for i, ns in enumerate((3 * SERVE_SEGMENT, SERVE_SEGMENT,
                            SERVE_SEGMENT)):
        srv.submit(ScenarioRequest(id=f"h{i}", ic="tc5", nsteps=ns, seed=i))
    CovStageCompact.launches = 0
    try:
        srv.serve()
    except HealthError:
        pass
    else:
        raise RuntimeError("halt: no HealthError")
    members += CovStageCompact.launches
    manifest, _ = flight.read_bundle(flight.latest_bundle(fdir))
    opened = manifest["open_requests"]
    if (srv.queue.snapshot() != ["h2"]
            or [r["id"] for r in opened["queued"]] != ["h2"]
            or sorted(r["id"] for r in opened["in_flight"])
            != ["h0", "h1"] or manifest["reason"] != "HealthError"):
        raise RuntimeError(f"halt: queue {srv.queue.snapshot()}, bundle "
                           f"{opened}")
    srv.close()
    log(f"serving guards C{N}: evict - member 1 evicted at step "
        f"{res['e1'].steps_run}, members 0 and 2 bitwise their solo runs; "
        f"halt - HealthError, the popped refill h2 back at the queue head, "
        f"the crash bundle's open requests {opened}; card {card}")
    return {"cov_stage_members mc f32": members}


def serving_gateway(card: str, root: str, packed_rate: float) -> dict:
    """Phase 78: the gateway and the load harness over phase 75's
    deployment.  Returns the stage launches by record name."""
    import os

    import numpy as np

    from jaxstream_torch.gateway import (Gateway, get_json, get_text,
                                         post_json, protocol,
                                         submit_streaming)
    from jaxstream_torch.gateway.client import (final_result,
                                                submit_websocket)
    from jaxstream_torch.loadgen import (AutoscaleController,
                                         AutoscalePolicy, generate_trace,
                                         run_load)
    from jaxstream_torch.obs.registry import parse_exposition
    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact
    from jaxstream_torch.serve import ScenarioRequest

    host = "127.0.0.1"
    serve_sink = os.path.join(root, "serve.jsonl")
    gw_sink = os.path.join(root, "gateway.jsonl")
    cfg = serve_config(buckets=f"1,4,{SERVE_PACKED}", trace=True,
                       sink=serve_sink)
    ctrl = AutoscaleController(AutoscalePolicy(
        levels=(1, 4, SERVE_PACKED), queue_high=4, queue_low=0,
        occ_low=0.5, patience=2, cooldown=2))
    gw = Gateway(cfg, host=host, port=0, autoscale=ctrl, warm=False,
                 sink=gw_sink, profile_dir=os.path.join(root, "profile"))
    gw.warm_compiles = gw.server.warmup(groups=("oro",))
    gw.start()
    try:
        CovStageCompact.launches = 0
        trace = generate_trace(SLO_REQUESTS, seed=SLO_SEED,
                               mean_gap_s=0.02, tail_alpha=1.4,
                               lengths=SLO_LENGTHS,
                               family_weights={"tc5": 1.0})
        summary = run_load(host, gw.port, trace, time_scale=1.0,
                           max_workers=16,
                           sink=os.path.join(root, "loadgen.jsonl"),
                           dt=STEP_DT, trace_spans=True,
                           span_sinks=[serve_sink, gw_sink])
        if not summary["accounting_exact"] or \
                summary["spans_complete"] != 1.0:
            raise RuntimeError(f"load harness: {summary}")
        body = {"id": "via-http", "ic": "tc5", "nsteps": 12, "seed": 5,
                "amplitude": 1e-3, "outputs": ["h", "u"]}
        _, http_ev = submit_streaming(host, gw.port, body)
        ws_ev = submit_websocket(host, gw.port, dict(body, id="via-ws"))
        if ws_ev[-1]["fields"] != http_ev[-1]["fields"]:
            raise RuntimeError("WebSocket fields differ from HTTP fields")
        gw.server.submit(ScenarioRequest.from_dict(dict(body,
                                                        id="direct")))
        t_wait = time.perf_counter() + 120
        while "direct" not in gw.server.results:
            if time.perf_counter() > t_wait:
                raise RuntimeError("direct submission: no result")
            time.sleep(0.01)
        direct = gw.server.results["direct"]
        via = final_result(http_ev)
        for k in ("h", "u"):
            if direct.fields[k].tobytes() != via.fields[k].tobytes():
                raise RuntimeError(f"gateway {k} differs from the direct "
                                   "submission")
        st, _ = post_json(host, gw.port, "/v1/profile", {"action": "start"})
        submit_streaming(host, gw.port, dict(body, id="profiled"))
        st2, prof = post_json(host, gw.port, "/v1/profile",
                              {"action": "stop"})
        with open(prof["trace"]) as fh:
            names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
        kernels = sorted(n for n in names if "cov_stage" in n)
        on_card = gw.server.device.type == "cuda"
        if (st, st2) != (200, 200) or "serve.segment" not in names \
                or (on_card and not kernels):
            raise RuntimeError(f"profile capture: {st} {st2}, kernels "
                               f"{kernels}")
        # The wire's host cost of one (h, u) result: the writer thread's
        # encode, the HTTP thread's serialization, the client's parse.
        t1 = time.perf_counter()
        line = json.dumps(protocol.result_event(direct))
        t2 = time.perf_counter()
        protocol.decode_result(json.loads(line))
        wire_ms = (1e3 * (t2 - t1), 1e3 * (time.perf_counter() - t2),
                   len(line) / 1e6)
        code, _, text = get_text(host, gw.port, "/v1/metrics")
        parsed = parse_exposition(text)
        code2, stats = get_json(host, gw.port, "/v1/stats")
        if code != 200 or code2 != 200 or \
                gw.server.compile_count() != gw.warm_compiles:
            raise RuntimeError(f"gateway: metrics {code}, stats {code2}, "
                               f"compile_count {gw.server.compile_count()}"
                               f" != {gw.warm_compiles}")
    finally:
        gw.close()
    launches = CovStageCompact.launches
    segs = read_records(serve_sink, kind="serve")
    single = 3 * SERVE_SEGMENT * sum(1 for r in segs if r["bucket"] == 1)
    if launches != 3 * SERVE_SEGMENT * len(segs):
        raise RuntimeError(f"gateway: stage launches {launches} != 3 x "
                           f"{SERVE_SEGMENT} x {len(segs)} segments")
    by_bucket = {b: sum(1 for r in segs if r["bucket"] == b)
                 for b in sorted({r["bucket"] for r in segs})}
    log(f"gateway + load harness C{N} ({SLO_REQUESTS} requests, seed "
        f"{SLO_SEED}, mean gap 0.02 s, tail alpha 1.4, lengths "
        f"{SLO_LENGTHS}): completed {summary['completed']}, shed "
        f"{summary['shed']}, errors {summary['errors']}; goodput "
        f"{summary['goodput_member_steps_per_sec']:.1f} member-steps/s = "
        f"{summary['goodput_member_steps_per_sec'] / packed_rate:.3f} of "
        f"phase 75's packed rate (the JAX package's floor 0.5); latency "
        f"p50 {summary['latency_p50_s']} s p99 {summary['latency_p99_s']} "
        f"s; span coverage {summary['spans_complete']}; autoscale resizes "
        f"{[(e['from_bucket'], e['to_bucket']) for e in ctrl.events]}; "
        f"segments by bucket {by_bucket}; HTTP == WebSocket == direct "
        f"bitwise; a profile capture holds serve.segment and {kernels}; "
        f"metrics families {len(parsed['types'])}; one (h, u) result on "
        f"the wire {wire_ms[2]:.2f} MB: encode + serialize "
        f"{wire_ms[0]:.1f} ms, parse + decode {wire_ms[1]:.1f} ms of host; "
        f"compile_count "
        f"{gw.warm_compiles} throughout; card {card}")
    return {"cov_stage_compact": single,
            "cov_stage_members mc f32": launches - single}


def serving_paths(card: str, t_start: float) -> dict:
    """Phases 75-78 (see the module docstring); their files in a
    directory of the checkout's ``build/``.  Returns each kernel record's
    launches on these paths, by record name."""
    import os
    import shutil
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_",
                            dir=os.path.join(here, "build"))
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    try:
        stamp(t_start, "grouped serving on B1 and its member fold "
              "(phase 75)")
        c, packed_rate = serving_grouped(card)
        add(c)
        stamp(t_start, "mixed-orography serving on B4 (phase 76)")
        add(serving_mixed(card))
        stamp(t_start, "serving guards (phase 77)")
        add(serving_guards(card, root))
        stamp(t_start, "gateway and load harness (phase 78)")
        add(serving_gateway(card, root, packed_rate))
        stamp(t_start, "serving phases done")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"launches on the serving paths (phases 75-78): {counts}")
    return counts


# ---------------------------------------------------------------------------
# Phase 79: the serving warm pool; phases 80-81: the tiers in every mode and
# face-tier del^4
# ---------------------------------------------------------------------------

#: Phase 79: the buckets of the pooled deployment and its three requests
#: (the ladder's first three lengths), each with h and u back.
POOL_BUCKETS = "1,4,16"
POOL_REQUESTS = 3


def pool_config(pool: str, **over) -> dict:
    """Phase 75's deployment with buckets 1, 4 and 16 under
    ``serve.warm_pool``."""
    cfg = serve_config(buckets=POOL_BUCKETS, warm_pool=pool)
    for k, v in over.items():
        cfg.setdefault(k, {}).update(v)
    return cfg


def pool_requests():
    from jaxstream_torch.serve import ScenarioRequest

    return [ScenarioRequest(id=f"w{i}", ic="tc5", nsteps=SERVE_LENGTHS[i],
                            seed=i, amplitude=1e-3, outputs=("h", "u"))
            for i in range(POOL_REQUESTS)]


def pool_serve(srv) -> tuple:
    """Warm every bucket of ``srv`` (B = 1 first, counted apart: B1's
    instance; the member fold after) and serve :func:`pool_requests`.
    Returns (the results' sha256 per request over h then u, launches by
    record name)."""
    import hashlib

    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact as Stage

    Stage.launches = 0
    srv._bucket("oro", 1)
    single = Stage.launches
    srv.warmup(groups=("oro",))
    for r in pool_requests():
        srv.submit(r)
    res = srv.serve()
    torch.cuda.synchronize()
    digests = {}
    for rid, r in sorted(res.items()):
        if r.status != "ok":
            raise RuntimeError(f"pooled request {rid}: {r.status}")
        digests[rid] = hashlib.sha256(
            r.fields["h"].tobytes() + r.fields["u"].tobytes()).hexdigest()
    return digests, {"cov_stage_compact": single,
                     "cov_stage_members mc f32": Stage.launches - single}


def warm_pool_child(spec_path: str) -> int:
    """Phase 79's restarted server, in a process of its own whose library
    directory starts empty: server B from the pool; writes its builds,
    warm-ups, digests and launches as JSON to ``spec['out']``."""
    from jaxstream_torch import _build

    with open(spec_path) as fh:
        spec = json.load(fh)
    _build.set_build_dir(spec["build_dir"])
    from jaxstream_torch.serve import EnsembleServer

    t0 = time.perf_counter()
    srv = EnsembleServer(pool_config(spec["pool"]))
    digests, launches = pool_serve(srv)
    out = {"nvcc_builds": _build.nvcc_builds,
           "table_builds": srv.stats["table_builds"],
           "compile_count": srv.compile_count(),
           "warmups": srv.bucket_warmups(),
           "summary": srv.warmpool_summary(),
           "libraries": sorted(_build.loaded_libraries()),
           "built_files": sorted(os.listdir(spec["build_dir"])),
           "digests": digests, "launches": launches,
           "wall_s": time.perf_counter() - t0}
    srv.close()
    with open(spec["out"], "w") as fh:
        json.dump(out, fh)
    return 0


def warm_pool_path(card: str, root: str) -> dict:
    """Phase 79: server A starts cold on an empty pool, saves its
    buckets' entries and serves three ladder requests; a child process
    whose library directory starts empty builds server B from the pool
    (no nvcc build, no table build, compile_count 0) and serves them
    byte-equal; one payload byte flipped gives a ``corrupt`` record, a
    rebuild and the same digests; a changed ``time.dt`` misses.  Returns
    the launches by record name."""
    from jaxstream_torch import _build
    from jaxstream_torch.obs.sink import read_records
    from jaxstream_torch.ops.cuda.swe_cov import CovStageCompact as Stage
    from jaxstream_torch.serve import EnsembleServer

    pool = os.path.join(root, "pool")
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    srv = EnsembleServer(pool_config(pool))
    nvcc0 = _build.nvcc_builds
    digests, c = pool_serve(srv)
    add(c)
    warm_a, summary_a = srv.bucket_warmups(), srv.warmpool_summary()
    srv.close()
    log(f"phase 79 server A (cold pool): warm-ups {warm_a}; nvcc builds "
        f"{_build.nvcc_builds - nvcc0} (this process built its libraries "
        f"in phase 1); pool saves {summary_a['saves']}; card {card}")
    if summary_a["saves"] != 3 or any(w["rung"] != "cold"
                                      for w in warm_a.values()):
        raise RuntimeError("server A did not save three cold buckets")
    spec = {"pool": pool, "build_dir": os.path.join(root, "child_build"),
            "out": os.path.join(root, "child.json")}
    os.makedirs(spec["build_dir"])
    with open(os.path.join(root, "child_spec.json"), "w") as fh:
        json.dump(spec, fh)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--warm-pool-child",
                           os.path.join(root, "child_spec.json")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"phase 79 child exited {proc.returncode}: "
                           f"{proc.stderr[-2000:]}")
    with open(spec["out"]) as fh:
        child = json.load(fh)
    add(child["launches"])
    log(f"phase 79 server B (a child process, empty library directory, "
        f"{time.perf_counter() - t0:.1f} s with its start): nvcc builds "
        f"{child['nvcc_builds']}, table builds {child['table_builds']}, "
        f"compile_count {child['compile_count']}; warm-ups "
        f"{child['warmups']}; libraries {child['libraries']} from the pool "
        f"({child['built_files']}); hits {child['summary']['hits']}; "
        f"card {card}")
    same = child["digests"] == digests
    log(f"phase 79 results sha256, A vs B: {digests} -> "
        f"{'equal' if same else child['digests']}")
    if (child["nvcc_builds"] or child["table_builds"]
            or child["compile_count"] or not same
            or child["summary"]["hits"] != 3
            or any(w["rung"] != "aot" for w in child["warmups"].values())):
        raise RuntimeError("phase 79: the restart from the pool built or "
                           "differed")
    # One byte of the B = 4 entry's library flipped: corrupt, rebuilt.
    b4 = None
    for f in os.listdir(pool):
        if f.endswith(".json") and not f.startswith("probe_"):
            with open(os.path.join(pool, f)) as fh:
                if json.load(fh)["plan_key"].endswith("/B4"):
                    b4 = f[:-5]
    payloads = sorted(f for f in os.listdir(pool)
                      if f.startswith(b4) and not f.endswith(".json"))
    # The member fold's library where the entry holds one, else its tables.
    victim = os.path.join(pool, ([f for f in payloads if f.endswith(".so")]
                                 or payloads)[0])
    with open(victim, "r+b") as fh:
        fh.seek(os.path.getsize(victim) // 2)
        byte = fh.read(1)[0]
        fh.seek(-1, os.SEEK_CUR)
        fh.write(bytes([byte ^ 0x01]))
    sink = os.path.join(root, "c.jsonl")
    srv = EnsembleServer(pool_config(pool, serve={"sink": sink}))
    digests_c, c = pool_serve(srv)
    add(c)
    summary_c = srv.warmpool_summary()
    srv.close()
    corrupt = [r for r in read_records(sink)
               if r["kind"] == "warmpool" and r["event"] == "corrupt"]
    log(f"phase 79 server C ({os.path.basename(victim)} one byte off): "
        f"corrupt records {len(corrupt)} ({corrupt[0]['reason'] if corrupt else ''}), "
        f"hits {summary_c['hits']}, saves {summary_c['saves']}; digests "
        + ("equal" if digests_c == digests else str(digests_c)))
    if (len(corrupt) != 1 or summary_c["saves"] != 1
            or digests_c != digests):
        raise RuntimeError("phase 79: the torn entry was not rebuilt the "
                           "same")
    srv = EnsembleServer(pool_config(pool, time={"dt": 2 * STEP_DT}))
    before = Stage.launches
    srv._bucket("oro", 1)
    add({"cov_stage_compact": Stage.launches - before})
    summary_d = srv.warmpool_summary()
    srv.close()
    log(f"phase 79 server D (time.dt {2 * STEP_DT:g}): hits "
        f"{summary_d['hits']}, misses {summary_d['misses']}")
    if summary_d["hits"] or summary_d["misses"] != 1:
        raise RuntimeError("phase 79: a changed dt did not miss")
    return counts


def tier_mode_path(card: str, mode: str, grids: dict) -> tuple:
    """Phase 80 for one reconstruction: TC5 at C384 in ``mode`` (halo 3
    for PPM) on the face tier (6 ranks) and the (6, 2, 2) block tier (24),
    serialized and overlapped.  The path first, its launches counted
    around it: 3 steps of each tier against 3 classic steps (<= 2e-4 of
    max, mass < 2e-6), and for PPM then 5 + 50 steps of each, gated as
    phase 32; then B4's stacked instance, B5's and B6's bitwise against
    their plain versions at the IC and on the face serialized run's
    state, and timed there.  Returns (the B5 and B6 records, B4's
    launches)."""
    from jaxstream_torch.config import EARTH_GRAVITY, EARTH_OMEGA
    from jaxstream_torch.models.shallow_water_cov import CovariantShallowWater
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.parallel.mesh import shard_state, unshard_state
    from jaxstream_torch.parallel.sharded_model import make_stepper_for
    from jaxstream_torch.stepping import integrate

    Rhs, Core, Local = swe_cov.CovRhs, swe_cov.CovRhsInterior, \
        swe_cov.CovRhsLocal
    scheme, limiter = RECON_MODES[mode]
    grid, h_ext, v_ext, b_ext = grids[3 if scheme == "ppm" else 2]
    model = CovariantShallowWater(grid, gravity=EARTH_GRAVITY,
                                  omega=EARTH_OMEGA, b_ext=b_ext,
                                  scheme=scheme, limiter=limiter)
    s0 = model.initial_state(h_ext, v_ext)
    ycl, _ = integrate(model.make_step(STEP_DT), s0, 0.0, 3, STEP_DT)
    area = grid.interior(grid.area).double()
    mass0 = float((area * s0["h"].double()).sum())

    # ---- the mode's tier paths, their launches counted around them ------
    Rhs.launches = Core.launches = Local.launches = 0
    nsteps = 3 + (TIER_WARM_STEPS + TIER_TIMED_STEPS if mode == "ppm"
                  else 0)
    runs = {}
    for tiles, overlap in ((1, False), (1, True), (2, False), (2, True)):
        tier = ("face" if tiles == 1 else "block") + (
            " overlapped" if overlap else " serialized")
        setup = tier_setup(tiles, overlap)
        step = make_stepper_for(model, setup, None, STEP_DT)
        y, t = integrate(step, shard_state(setup, s0), 0.0, 3, STEP_DT)
        out = runs[tier] = unshard_state(setup, y)
        errs = {k: rel_err(ycl[k], out[k]) for k in ("h", "u")}
        drift = abs(float((area * out["h"].double()).sum()) - mass0) / mass0
        log(f"{mode} {tier} tier vs classic C{N}, 3 steps: max rel diff h "
            f"{errs['h']:.3e}, u {errs['u']:.3e} (tol "
            f"{TIER_VS_CLASSIC_TOL:g}); mass drift {drift:.3e} (tol "
            f"{TIER_MASS_TOL:g})")
        if max(errs.values()) > TIER_VS_CLASSIC_TOL or drift > TIER_MASS_TOL:
            raise RuntimeError(f"{mode} {tier} tier outside its budget")
        if mode == "ppm":
            y, t = integrate(step, y, t, TIER_WARM_STEPS, STEP_DT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, t = integrate(step, y, t, TIER_TIMED_STEPS, STEP_DT)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            tc5_gate(f"PPM {tier} tier", grid, s0,
                     unshard_state(setup, y)["h"], t / 86400.0)
            log(f"main path C{N} TC5 PPM (halo 3) {tier} tier "
                f"({setup.num_devices} virtual ranks): {TIER_TIMED_STEPS} "
                f"steps in {wall:.3f} s -> {TIER_TIMED_STEPS / wall:.1f} "
                f"steps/s, {wall / TIER_TIMED_STEPS * 1e6:.1f} us/step; card "
                f"{card}")
    launches = (Rhs.launches, Core.launches, Local.launches)
    if launches != (3 * nsteps, 6 * nsteps, 3 * nsteps):
        raise RuntimeError(f"{mode} tiers: launches (B4, B5, B6) {launches}"
                           f" != (3, 6, 3) x {nsteps}")
    log(f"{mode} tier paths: {nsteps} steps each; launches B4 stacked "
        f"{launches[0]}, B5 {launches[1]}, B6 {launches[2]}")

    # ---- 80. B4 stacked, B5 and B6 vs plain at the IC and on the run ----
    consts = (grid.halo, grid.dalpha, grid.radius, model.gravity,
              model.omega)
    kw = dict(scheme=scheme, limiter=limiter)
    nl = N // 2
    face_core = swe_cov.make_cov_rhs_interior_local(N, *consts, **kw)
    block_core = swe_cov.make_cov_rhs_interior_local(nl, *consts, **kw)
    block_rhs = swe_cov.make_cov_rhs_pallas_local(nl, *consts, **kw)
    one = swe_cov.make_cov_rhs_pallas(grid, model.gravity, model.omega,
                                      n_faces=1, external_sym=True, **kw)
    if {k.mode for k in (face_core, block_core, block_rhs, one)} != {mode}:
        raise RuntimeError(f"{mode}: a tier kernel is in another mode")
    max_b4 = max_b5 = max_b6 = 0.0
    forms = {}
    for label, st in (("TC5 state", s0),
                      ("after 3 face-tier steps", runs["face serialized"])):
        _, _, b5, rhs, _, b5s, b4s = tier_operands(model, st, 1)
        max_b5 = max(max_b5, check_stacked(
            f"B5 {mode} stacked vs plain C{N}, 6 faces, {label}", face_core,
            b5s, b5)[0])
        max_b4 = max(max_b4, check_stacked(
            f"B4 {mode} stacked vs plain C{N}, 6 faces, {label}", one, b4s,
            rhs)[0])
        _, _, b5b, rhsb, _, b5sb, b6s = tier_operands(model, st, 2)
        max_b6 = max(max_b6, check_stacked(
            f"B6 {mode} stacked vs plain C{N}, 24 blocks, {label}",
            block_rhs, b6s, rhsb)[0])
        max_b5 = max(max_b5, check_stacked(
            f"B5 {mode} stacked vs plain C{N}, 24 block cores, {label}",
            block_core, b5sb, b5b)[0])
        forms = {"b5": b5s, "b4": b4s, "b5b": b5sb, "b6": b6s}
    h = grid.halo
    ni, nbi = N - 2 * h, nl - 2 * h
    timed_b5 = [
        time_form(f"B5 {mode} stacked, face tier", face_core.stacked,
                  face_core.stacked_reference, forms["b5"], FLOPS_PER_CELL,
                  card, 6 * ni * ni, read=stacked_read(forms["b5"])),
        time_form(f"B5 {mode} stacked, block tier", block_core.stacked,
                  block_core.stacked_reference, forms["b5b"],
                  FLOPS_PER_CELL, card, 24 * nbi * nbi,
                  read=stacked_read(forms["b5b"]))]
    timed_b6 = [time_form(f"B6 {mode} stacked, block tier",
                          block_rhs.stacked, block_rhs.stacked_reference,
                          forms["b6"], FLOPS_PER_CELL, card, 24 * nl * nl,
                          read=stacked_read(forms["b6"]))]
    timed_b4 = [time_form(f"B4 {mode} stacked, face tier", one.stacked,
                          one.stacked_reference, forms["b4"],
                          FLOPS_PER_CELL, card, 6 * N * N,
                          read=stacked_read(forms["b4"]))]
    # B4's stacked form is the instance of B4's own record for the mode
    # (phase 37): logged here, its launches join that record.
    mode_record("cov_rhs", f"{mode} stacked",
                "jaxstream/ops/pallas/swe_cov.py:508", launches[0], max_b4,
                timed_b4, card)
    return ([mode_record("cov_rhs_interior", mode,
                         "jaxstream/ops/pallas/swe_cov.py:733", launches[1],
                         max_b5, timed_b5, card),
             mode_record("cov_rhs_local", mode,
                         "jaxstream/ops/pallas/swe_cov.py:610", launches[2],
                         max_b6, timed_b6, card)],
            {f"cov_rhs {mode}": launches[0]})


def face_nu4_path(card: str) -> dict:
    """Phase 81: the Galewsky jet (nu4 = 1e14 m^4/s, dt = 60 s) on the
    face tier, serialized and overlapped: 3 steps against 3 classic del^4
    steps (<= 5e-4 of max, the JAX package's budget), then 5 + 50 steps
    gated (finite, Galewsky's h range, mass < 2e-6) and timed.  Returns
    the launches by record name (B4 serialized, B5 overlapped)."""
    from jaxstream_torch.ops.cuda import swe_cov
    from jaxstream_torch.parallel.mesh import shard_state, unshard_state
    from jaxstream_torch.parallel.sharded_model import make_stepper_for
    from jaxstream_torch.stepping import integrate

    Rhs, Core = swe_cov.CovRhs, swe_cov.CovRhsInterior
    gal = Galewsky()
    yc, _ = integrate(gal.model.make_step(GAL_DT), gal.s0, 0.0, 3, GAL_DT)
    Rhs.launches = Core.launches = 0
    for overlap in (False, True):
        form = "overlapped" if overlap else "serialized"
        setup = tier_setup(1, overlap)
        step = make_stepper_for(gal.model, setup, None, GAL_DT)
        y, t = integrate(step, shard_state(setup, gal.s0), 0.0, 3, GAL_DT)
        gal.compare(f"face tier del^4 ({form}) vs classic del^4",
                    yc, unshard_state(setup, y), STAGE_VS_CLASSIC_TOL,
                    TIER_MASS_TOL)
        y, t = integrate(step, y, t, TIER_WARM_STEPS, GAL_DT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y, t = integrate(step, y, t, TIER_TIMED_STEPS, GAL_DT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        h = unshard_state(setup, y)["h"].double()
        drift = gal.drift(h)
        hmin, hmax = float(h.min()), float(h.max())
        ok = (bool(torch.isfinite(h).all()) and 8500.0 < hmin
              and hmax < 10800.0 and drift < TIER_MASS_TOL)
        log(f"gate Galewsky C{N} nu4 face tier ({form}, 6 virtual ranks) "
            f"after {3 + TIER_WARM_STEPS + TIER_TIMED_STEPS} steps: h_range="
            f"[{hmin:.1f}, {hmax:.1f}] (in (8500, 10800)) mass_drift="
            f"{drift:.3e} (<{TIER_MASS_TOL:g}); {TIER_TIMED_STEPS} steps in "
            f"{wall:.3f} s -> {TIER_TIMED_STEPS / wall:.1f} steps/s, "
            f"{wall / TIER_TIMED_STEPS * 1e6:.1f} us/step; card {card} -> "
            + ("passed" if ok else "FAILED"))
        if not ok:
            raise RuntimeError(f"face tier del^4 ({form}): gate failed")
    n = 3 + TIER_WARM_STEPS + TIER_TIMED_STEPS
    if (Rhs.launches, Core.launches) != (3 * n, 3 * n):
        raise RuntimeError(f"face tier del^4 launches (B4, B5) "
                           f"{(Rhs.launches, Core.launches)} != 3 x {n}")
    return {"cov_rhs": Rhs.launches, "cov_rhs_interior": Core.launches}


def pool_and_tier_paths(card: str, t_start: float) -> tuple:
    """Phases 79-81; their files in a directory of the checkout's
    ``build/``.  Returns (the tier mode records, the launches by record
    name)."""
    import shutil
    import tempfile

    from jaxstream_torch.config import (EARTH_GRAVITY, EARTH_OMEGA,
                                        EARTH_RADIUS)
    from jaxstream_torch.geometry.cubed_sphere import build_grid
    from jaxstream_torch.physics.initial_conditions import williamson_tc5

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_serve_pool_",
                            dir=os.path.join(here, "build"))
    counts: dict = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    try:
        stamp(t_start, "the serving warm pool (phase 79)")
        add(warm_pool_path(card, root))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grids = {}
    for halo in (2, 3):
        g = build_grid(N, halo=halo, radius=EARTH_RADIUS,
                       dtype=torch.float32)
        grids[halo] = (g,) + williamson_tc5(g, EARTH_GRAVITY, EARTH_OMEGA)
    records = []
    for mode in RECON_MODES:
        stamp(t_start, f"the tiers in {mode} (phase 80)")
        recs, c = tier_mode_path(card, mode, grids)
        records += recs
        add(c)
    del grids
    stamp(t_start, "face-tier del^4 (phase 81)")
    add(face_nu4_path(card))
    stamp(t_start, "phases 79-81 done")
    log(f"launches on phases 79-81: {counts}")
    return records, counts


def build_kernels() -> None:
    """Phase 1's builds: every kernel library, one nvcc per source, all
    started together, with each library's ptxas lines, its PLR-MC
    functions against ``EARLIER_PTXAS`` and its mode instances logged."""
    from jaxstream_torch import _build

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
            usage = ptxas_usage(b.log)
            got = [tuple(use) for fn, *use in usage
                   if not MODE_KERNEL.search(fn)]
            log(f"  ptxas (registers, smem, spill stores) {got}: "
                + ("as before" if got == want else f"before: {want}"))
            modes = [(" ".join(MODE_KERNEL.search(fn).groups()), *use)
                     for fn, *use in usage if MODE_KERNEL.search(fn)]
            if modes:
                log(f"  ptxas of the mode instances (mode, registers, "
                    f"smem, spill stores): {modes}")
            if b.name in EARLIER_SASS:
                sass = sass_counts(b.path)
                got = [sass.get(fn, -1) for fn, *_ in usage
                       if not MODE_KERNEL.search(fn)]
                was = EARLIER_SASS[b.name]
                log(f"  SASS of the PLR-MC functions {got}: "
                    + ("as before" if got == was else f"before: {was}")
                    + "; of the mode instances "
                    + str([(" ".join(MODE_KERNEL.search(fn).groups()),
                            sass.get(fn, -1)) for fn, *_ in usage
                           if MODE_KERNEL.search(fn)]))
        if b.name in _build.POLICY_KERNELS and b.log:
            sass = sass_counts(b.path)
            log("  policy instances (kernel, registers, smem, spill "
                "stores, SASS): " + str([
                    (POLICY_KERNEL.search(fn).group(1), *use,
                     sass.get(fn, -1))
                    for fn, *use in ptxas_usage(b.log)
                    if POLICY_KERNEL.search(fn)]))


def main() -> int:
    if sys.argv[1:2] == ["--warm-pool-child"]:
        return warm_pool_child(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's main path runs on "
              "the GPU", file=sys.stderr)
        return 1

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
    build_kernels()

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
    recon_records = recon_paths(card, t_start)
    simulation_paths(card, t_start)
    recon_records += fused_recon_paths(card, t_start)
    recon_records += router_free_and_nu4_recon_paths(card, t_start)
    policy_records = policy_paths(card, t_start, grid, model, h_ext, v_ext,
                                  step, s0)
    obs_launches = telemetry_paths(card, t_start)
    for k, v in serving_paths(card, t_start).items():
        obs_launches[k] = obs_launches.get(k, 0) + v
    tier_mode_records, pool_tier_launches = pool_and_tier_paths(card,
                                                                t_start)
    for k, v in pool_tier_launches.items():
        obs_launches[k] = obs_launches.get(k, 0) + v
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
              + [mega_record, nbr_record] + tier_records + recon_records
              + policy_records + tier_mode_records}
    # Each kernel's launches on the telemetry and serving paths join its
    # own path's.
    for rec in report["kernels"]:
        rec["launches"] += obs_launches.pop(rec["name"], 0)
    if obs_launches:
        raise RuntimeError(f"telemetry/serving/tier launches of no "
                           f"record: {obs_launches}")
    log(json.dumps(report))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
