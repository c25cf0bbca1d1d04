"""The declarative composition-rule table (round 16).

Counterpart of :mod:`jaxstream.plan.rules`, whose code this module keeps
as it is (pure Python in both packages; the port keeps its own copy, so
that it imports nothing of the JAX package). Names, record kinds,
messages and outputs are the JAX module's.

Ten rounds of features each shipped a gated stepper factory, and the
legality of composing them lived as scattered ``raise ValueError``
prose in ``make_stepper_for``, ``make_fused_step``,
``Simulation._resolve_precision`` and the serving layer.  This module
is the ONE place that knowledge now lives: a table of
:class:`Rule` edges over :class:`~jaxstream.plan.plan.CapabilityPlan`
fields, each carrying the pointer message the legacy raise carried.

Three edge kinds:

* ``requires`` — when the ``when`` clauses match, the ``then`` clauses
  must also hold, else the plan is illegal (pointer raised).
* ``excludes`` — the ``when`` clauses alone name an illegal
  combination (pointer raised).
* ``implies`` — canonicalization, never an error: when ``when``
  matches, the ``then`` fields are forced to their single values
  (an inert knob — e.g. ``overlap_exchange`` on a tier with no
  explicit exchange — is normalized away, so two configs that compile
  the same program resolve to the SAME plan).

Because legality is decided by this table alone,
:func:`enumerate_plans` can *walk* it: take the per-tier axis value
sets (:data:`DEFAULT_AXES`), form every candidate, drop non-canonical
ones (``implies``), drop illegal ones (``requires``/``excludes``), and
what remains is the complete legal plan space at the given resolution.
``jaxstream.analysis.contracts`` verifies that whole space, so a new
feature flag either enters the verified matrix (add its axis values)
or names the rule that forbids it — there is no third, silent state.

:data:`RULES_VERSION` is bumped whenever the table's semantics change;
proof stamps and the bench ``contract_check`` stamp carry it so a
stale verdict is visible.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Sequence, Tuple, Union

__all__ = [
    "RULES_VERSION", "Rule", "RuleViolation", "PlanError", "RULES",
    "DEFAULT_AXES", "TIERS", "SCHEDULE_ONLY_TIERS", "EXCHANGE_TIERS",
    "check_plan", "normalize", "reject_illegal", "fail",
    "enumerate_plans", "plan_space_keys", "rule",
]

#: Bump when a rule is added/removed or its semantics change — proof
#: stamps, comm_probe plans and the bench contract stamp all carry it.
#: v2 (round 18): the ``da`` axis (EnKF-cycled forecast plans) and its
#: four composition edges entered the table.
RULES_VERSION = 2

#: Every capability tier a config can resolve to.  ``schedule_only``
#: tiers cannot be traced on the in-process device pool (the block
#: mesh needs 24 devices), so their proof rests on the pure
#: exchange-schedule pass alone.
TIERS = ("fused", "classic", "face", "face_block", "cartesian_shard",
         "gspmd", "tt", "tt_sharded")
SCHEDULE_ONLY_TIERS = ("face_block", "cartesian_shard")
#: Tiers whose steppers issue the explicit 4-stage ppermute schedule
#: (their proof stamps pin the canonical schedule fingerprint).
EXCHANGE_TIERS = ("face", "face_block", "cartesian_shard",
                  "tt_sharded")

Spec = Union[Tuple, Callable]


@dataclasses.dataclass(frozen=True)
class Rule:
    """One composition edge.  ``when``/``then`` are ``((field, spec),
    ...)`` clause tuples; a spec is a tuple of allowed values or a
    predicate.  ``pointer`` is the rejection message (str.format-able
    with ``plan=<the plan>``)."""

    name: str
    kind: str                      # 'requires' | 'excludes' | 'implies'
    when: Tuple[Tuple[str, Spec], ...]
    then: Tuple[Tuple[str, Spec], ...] = ()
    pointer: str = ""


@dataclasses.dataclass(frozen=True)
class RuleViolation:
    rule: str
    pointer: str

    def __str__(self):
        return f"[plan.rules/{self.rule}] {self.pointer}"


class PlanError(ValueError):
    """An illegal capability plan — raised statically, before any
    grid/model build or trace.  Subclasses ValueError so every legacy
    ``pytest.raises(ValueError, match=...)`` contract keeps holding.
    """

    def __init__(self, violations: Sequence[RuleViolation], plan=None):
        self.violations = tuple(violations)
        self.plan = plan
        head = (f"illegal capability plan"
                + (f" [{plan.key()}]" if plan is not None else "")
                + ": ")
        super().__init__(head + "; ".join(v.pointer
                                          for v in self.violations))


def _match(value, spec: Spec) -> bool:
    if callable(spec):
        return bool(spec(value))
    return value in spec


def _clauses_hold(plan, clauses) -> bool:
    return all(_match(getattr(plan, f), spec) for f, spec in clauses)


class _Missing(dict):
    def __missing__(self, key):          # tolerate absent format args
        return "{" + key + "}"


def _render(rule: Rule, plan=None, **fmt) -> str:
    args = _Missing(fmt)
    if plan is not None:
        for f in dataclasses.fields(plan):
            args.setdefault(f.name, getattr(plan, f.name))
        args.setdefault("deep_halo", plan.deep_halo)
    try:
        return rule.pointer.format_map(args)
    except Exception:
        return rule.pointer


# ---------------------------------------------------------------------
# The table.  Pointer texts are the legacy raise messages, verbatim
# where tests match on them — these strings are the single source the
# factories now raise from (tests/test_plan.py holds the parity).
# ---------------------------------------------------------------------

def _r(name, kind, when, then=(), pointer=""):
    return Rule(name, kind, tuple(when), tuple(then), pointer)


RULES: Tuple[Rule, ...] = (
    # -- precision composition ---------------------------------------
    _r("stage-policy-needs-fused", "excludes",
       [("tier", ("face", "face_block", "cartesian_shard", "gspmd")),
        ("stage_policy_on", (True,))],
       pointer=(
           "the per-stage precision policy rides the single-device "
           "fused covariant stepper (make_fused_step(precision=...)); "
           "the sharded/classic tiers built here run f32 numerics — "
           "drop the precision: block, or run single-device; wire-byte "
           "accounting for 16-bit strips is available via "
           "scripts/comm_probe.py --strip-dtype bf16")),
    _r("precision-needs-fused-path", "excludes",
       [("tier", tuple(t for t in TIERS if t != "fused")),
        ("precision_touched", (True,))],
       pointer=(
           "the precision: block (stage/strips/carry != f32) and "
           "model.nu4_mode != 'split' ride the single-device fused "
           "covariant stepper: they need model.backend: pallas, "
           "time.scheme: ssprk3, model.numerics: dense and "
           "parallelization.num_devices: 1 (sharded tiers take the "
           "wire accounting only — scripts/comm_probe.py "
           "--strip-dtype bf16)")),
    _r("carry-encoding-needs-fused", "excludes",
       [("tier", ("face", "face_block", "cartesian_shard", "gspmd")),
        ("carry", lambda v: v != "f32")],
       pointer=(
           "precision.carry != 'f32' (16-bit carry storage) rides the "
           "single-device fused covariant stepper: it needs "
           "model.backend: pallas, time.scheme: ssprk3, "
           "model.numerics: dense and parallelization.num_devices: 1")),
    _r("carry-needs-single-member", "excludes",
       [("carry", lambda v: v != "f32"),
        ("ensemble", lambda v: v > 1)],
       pointer=(
           "precision.carry encodings are wired for single runs "
           "(members: 1); the batched ensemble carry stays f32")),
    _r("carry-needs-covariant", "requires",
       [("tier", ("fused",)), ("carry", lambda v: v != "f32")],
       [("covariant", (True,))],
       pointer=(
           "precision.carry != 'f32' needs the covariant dense model "
           "(model.numerics: dense, shallow-water family)")),
    _r("stage-needs-compact-carry", "requires",
       [("tier", ("fused",)), ("stage", lambda v: v != "f32")],
       [("covariant", (True,))],
       pointer=(
           "precision: block needs the compact-carry fused stepper "
           "(this model only has the extended-state form) — set "
           "model.name: shallow_water_cov")),
    _r("nu4-stage-oracle-f32", "excludes",
       [("tier", ("fused",)), ("nu4", (True,)),
        ("nu4_mode", ("stage",)),
        ("stage_policy_on", (True,))],
       pointer=(
           "nu4_mode='stage' is the f32 parity oracle and takes no "
           "precision policy; use nu4_mode='split' or 'refused'")),
    _r("nu4-no-carry-encoding", "excludes",
       [("tier", ("fused",)), ("nu4", (True,)),
        ("carry", lambda v: v != "f32")],
       pointer=(
           "carry_dtype/h_offset/u_scale/_ablate_seam are not "
           "supported on the nu4 paths")),

    # -- explicit covariant tiers ------------------------------------
    _r("explicit-cov-ssprk3", "requires",
       [("tier", ("face", "face_block"))],
       [("scheme", ("ssprk3",))],
       pointer=(
           "the explicit covariant shard path implements ssprk3 only; "
           "got scheme={scheme!r}")),
    _r("ensemble-face-tier", "excludes",
       [("tier", ("face_block",)), ("ensemble", lambda v: v > 1)],
       pointer=(
           "batched ensemble stepping is wired for the face tier (one "
           "face per device, optionally x member shards); set "
           "tiles_per_edge: 1 — got a sub-panel split")),
    _r("ensemble-needs-cov-or-gspmd", "excludes",
       [("tier", ("cartesian_shard",)),
        ("ensemble", lambda v: v > 1)],
       pointer=(
           "batched ensemble stepping is wired for the covariant "
           "explicit tiers and the GSPMD/single-device paths; set "
           "model.name: shallow_water_cov or use_shard_map: false")),
    _r("temporal-block-cartesian", "excludes",
       [("tier", ("cartesian_shard",)),
        ("temporal_block", lambda v: v > 1)],
       pointer=(
           "parallelization.temporal_block > 1 is wired for the "
           "covariant explicit tiers, the single-device fused stepper, "
           "the GSPMD path, and the factored TT tier; the Cartesian "
           "explicit shard_map path steps serially — set "
           "temporal_block: 1 or model.name: shallow_water_cov")),
    _r("deep-halo-fits", "requires",
       [("tier", ("face",)), ("ensemble", (0, 1)),
        ("temporal_block", lambda v: v > 1)],
       [("fits_deep_halo", (True,))],
       pointer=(
           "temporal_block={temporal_block} needs n >= 3*k*halo "
           "= {deep_halo} deep ghost strips on the face tier; "
           "n={n} is too small — lower temporal_block or raise "
           "the resolution")),

    # -- ensembles ----------------------------------------------------
    _r("ensemble-shallow-water", "requires",
       [("ensemble", lambda v: v > 1)],
       [("family", ("shallow_water",))],
       pointer=(
           "ensemble.members > 1 supports the shallow-water family "
           "(tc2/tc5/tc6/galewsky); this initial_condition drives "
           "{family!r}")),
    _r("ensemble-dense-only", "excludes",
       [("tier", ("tt", "tt_sharded")),
        ("ensemble", lambda v: v > 1)],
       pointer=(
           "ensemble.members > 1 runs the dense tier only; set "
           "model.numerics: dense (the factored TT state has no "
           "batched stepper yet)")),
    _r("fused-ensemble-nu4", "excludes",
       [("tier", ("fused",)), ("nu4", (True,)),
        ("ensemble", lambda v: v > 1)],
       pointer=(
           "ensemble > 0 supports nu4 = 0 only (the del^4 filter "
           "kernels are not batched yet); run ensemble_impl='vmap' "
           "over a nu4 stepper manually if needed")),

    # -- factored (TT) tier -------------------------------------------
    _r("tt-six-devices", "requires",
       [("tier", ("tt_sharded",))],
       [("num_devices", (6,))],
       pointer=(
           "model.numerics='tt' shards one face per device over a "
           "6-device ('panel',) mesh (jaxstream.tt.shard); set "
           "parallelization.num_devices: 6 — got "
           "{num_devices}")),
    _r("tt-no-tiles", "requires",
       [("tier", ("tt", "tt_sharded"))],
       [("tiles_per_edge", (1,))],
       pointer=(
           "model.numerics='tt' supports tiles_per_edge: 1 only (the "
           "factored state is O(n r) per panel; intra-panel tiling is "
           "not meaningful) — got {tiles_per_edge}")),
    _r("tt-scheme", "requires",
       [("tier", ("tt", "tt_sharded"))],
       [("scheme", ("ssprk3", "euler"))],
       pointer=(
           "model.numerics='tt' supports time.scheme 'ssprk3' or "
           "'euler', not {scheme!r}")),
    _r("tt-no-nu4", "excludes",
       [("tier", ("tt", "tt_sharded")), ("nu4", (True,))],
       pointer=(
           "model.numerics='tt' has no nu4 hyperdiffusion; set "
           "physics.hyperdiffusion: 0 (or run numerics: dense)")),
    _r("tt-halo", "requires",
       [("tier", ("tt", "tt_sharded"))],
       [("halo", lambda v: v >= 1)],
       pointer=(
           "model.numerics='tt' needs grid.halo >= 1 (the factored "
           "edge statics read the innermost ghost cell at index "
           "halo-1; with halo={halo} that wraps to the opposite "
           "panel edge); set grid.halo: 1 or higher")),
    _r("tt-no-obs", "excludes",
       [("tier", ("tt", "tt_sharded")),
        ("obs_interval", lambda v: v > 0)],
       pointer=(
           "observability.interval > 0 requires model.numerics: dense "
           "(the factored TT state has no in-loop metric path; eager "
           "Simulation.diagnostics() still works)")),

    # -- observability -------------------------------------------------
    _r("obs-interval-temporal-block", "requires",
       [("obs_interval", lambda v: v > 0)],
       [("obs_interval_aligned", (True,))],
       pointer=(
           "observability.interval={obs_interval} must be a "
           "multiple of parallelization.temporal_block="
           "{temporal_block} (samples are taken at stepper-call "
           "boundaries)")),

    # -- serving -------------------------------------------------------
    _r("serve-dense", "requires",
       [("serving", (True,))],
       [("tier", ("classic", "fused", "face", "gspmd"))],
       pointer=(
           "the serving tier runs the dense covariant solvers; set "
           "model.numerics: dense")),
    _r("serve-covariant", "requires",
       [("serving", (True,))],
       [("covariant", (True,))],
       pointer=(
           "the serving tier runs the covariant production solver "
           "only — set model.name: shallow_water_cov (so an unbatched "
           "Simulation of the same config is the bitwise reference)")),
    _r("serve-f32", "requires",
       [("serving", (True,))],
       [("stage", ("f32",)), ("strips", ("f32", "auto")),
        ("carry", ("f32",))],
       pointer=(
           "the serving tier runs f32 numerics; the precision: block "
           "is not threaded through the bucket steppers yet — drop it "
           "rather than silently serving f32")),
    _r("serve-no-temporal-block", "requires",
       [("serving", (True,))],
       [("temporal_block", (1,))],
       pointer=(
           "parallelization.temporal_block > 1 is not wired into the "
           "serving tier (per-member masking counts single steps); "
           "set temporal_block: 1")),
    _r("serve-placement-not-shard-flags", "requires",
       [("serving", (True,))],
       [("use_shard_map", (False,)), ("tiles_per_edge", (1,))],
       pointer=(
           "the serving tier drives devices through the "
           "serve.placement: block (mode member/panel), not the "
           "parallelization flags — drop use_shard_map/tiles_per_edge "
           "(they configure Simulation runs)")),
    _r("serve-member-jnp", "requires",
       [("serving", (True,)), ("placement", ("member",))],
       [("backend", ("jnp",))],
       pointer=(
           "placement mode 'member' partitions the vmapped classic "
           "stepper over the member mesh axis; the fused Pallas "
           "kernels fold every member into ONE custom call GSPMD "
           "cannot split — set model.backend: jnp, or placement mode: "
           "panel (the shard_map per-face kernel path)")),
    _r("serve-panel-grouping", "requires",
       [("serving", (True,)), ("placement", ("panel",))],
       [("serve_grouping", (True,))],
       pointer=(
           "placement mode 'panel' runs the shard_map ensemble "
           "stepper, which bakes orography per device — set "
           "serve.group_by_orography: true (mixed-orography batches "
           "are a member-parallel / single-chip feature)")),
    _r("serve-panel-ssprk3", "requires",
       [("serving", (True,)), ("placement", ("panel",))],
       [("scheme", ("ssprk3",))],
       pointer=(
           "placement mode 'panel' runs the explicit ssprk3 face "
           "tier; set time.scheme: ssprk3")),

    # -- ensemble data assimilation (round 18) -------------------------
    _r("da-needs-ensemble", "requires",
       [("da", (True,))],
       [("ensemble", lambda v: v > 1)],
       pointer=(
           "da.cycles > 0 runs the EnKF analysis over the member "
           "axis; set ensemble.members >= 2 (a single member has no "
           "ensemble covariance to filter with)")),
    _r("da-single-device", "requires",
       [("da", (True,))],
       [("tier", ("fused", "classic")), ("num_devices", (1,))],
       pointer=(
           "the in-process EnKF cycle drives the single-device "
           "batched steppers (the analysis update contracts the "
           "member axis — every member reads every member's "
           "anomalies, an all-gather the cycle driver does not "
           "issue on a sharded mesh); set num_devices: 1 and "
           "use_shard_map: false, or run multi-chip ensembles "
           "through the gateway client (scripts/assimilate.py "
           "--mode gateway)")),
    _r("da-no-temporal-block", "requires",
       [("da", (True,))],
       [("temporal_block", (1,))],
       pointer=(
           "da.cycle_steps counts single steps and analysis states "
           "re-enter the forecast at cycle boundaries; set "
           "parallelization.temporal_block: 1")),
    _r("da-f32", "excludes",
       [("da", (True,)), ("stage_policy_on", (True,))],
       pointer=(
           "the EnKF analysis is f32 linear algebra over the member "
           "axis and analysis states re-enter the forecast "
           "byte-preserved; run the cycle with the precision: block "
           "off (all-f32)")),

    # -- canonicalization (implies: inert knobs normalize away) -------
    _r("overlap-needs-explicit-exchange", "implies",
       [("tier", ("fused", "classic", "gspmd", "tt"))],
       [("overlap", False)]),
    _r("serve-member-or-off-no-overlap", "implies",
       [("serving", (True,)), ("placement", ("off", "member"))],
       [("overlap", False)]),
    # A serving bucket is never itself a da plan: the gateway-client
    # cycle rides ordinary serving plans (the analysis lives in the
    # client), so the marker normalizes away.
    _r("serve-no-da", "implies",
       [("serving", (True,))],
       [("da", False)]),
)

_BY_NAME: Dict[str, Rule] = {r.name: r for r in RULES}
assert len(_BY_NAME) == len(RULES), "duplicate rule names in the table"


def rule(name: str) -> Rule:
    """Look one rule up by name (KeyError on unknown)."""
    return _BY_NAME[name]


def fail(name: str, plan=None, **fmt):
    """Raise the named rule's pointer as a :class:`PlanError`.

    The single-sourcing hook for the legacy factories: where
    ``make_stepper_for``/``make_fused_step`` used to carry their own
    prose, they now raise the table's pointer — so the message a
    direct factory call raises and the message ``plan_for`` raises for
    the same illegal pair can never drift apart.
    """
    r = _BY_NAME[name]
    raise PlanError([RuleViolation(r.name, _render(r, plan, **fmt))],
                    plan)


def normalize(plan):
    """Apply every ``implies`` edge (canonicalization).  Returns a
    plan whose inert knobs are forced to their canonical values."""
    changed = {}
    for r in RULES:
        if r.kind != "implies":
            continue
        if _clauses_hold(plan, r.when):
            for f, v in r.then:
                if getattr(plan, f) != v:
                    changed[f] = v
    return dataclasses.replace(plan, **changed) if changed else plan


def is_canonical(plan) -> bool:
    return normalize(plan) == plan


def check_plan(plan) -> List[RuleViolation]:
    """Every ``requires``/``excludes`` violation of one plan."""
    out = []
    for r in RULES:
        if r.kind == "implies" or not _clauses_hold(plan, r.when):
            continue
        if r.kind == "excludes":
            out.append(RuleViolation(r.name, _render(r, plan)))
        elif not _clauses_hold(plan, r.then):
            out.append(RuleViolation(r.name, _render(r, plan)))
    return out


def reject_illegal(plan):
    """Raise :class:`PlanError` when the (normalized) plan breaks any
    rule; returns the normalized plan otherwise."""
    plan = normalize(plan)
    violations = check_plan(plan)
    if violations:
        raise PlanError(violations, plan)
    return plan


# ---------------------------------------------------------------------
# Enumeration: the complete legal plan space over declared axis values
# ---------------------------------------------------------------------

#: Per-tier axis value sets the enumeration explores.  ``"*"`` is the
#: default for tiers without their own entry — a NEW tier
#: automatically enters the walk with the conservative defaults, and a
#: new feature flag enters the verified matrix by adding its axis
#: values here (or is pruned by the rule that forbids it — never
#: silently absent).  Values are representative, not exhaustive
#: (B=2 stands for "batched", k=2 for "blocked"): the contracts the
#: analyzer proves are count/structure contracts that scale trivially
#: in B and k, and the runtime parity budgets are declared per plan.
DEFAULT_AXES = {
    "tier": ("fused", "classic", "face", "gspmd", "tt", "tt_sharded"),
    "overlap": {"face": (False, True), "tt_sharded": (False, True),
                "*": (False,)},
    "temporal_block": {"fused": (1, 2), "classic": (1, 2),
                       "face": (1, 2), "gspmd": (1, 2),
                       "tt_sharded": (1, 2), "*": (1,)},
    "ensemble": {"fused": (1, 2), "classic": (1, 2), "face": (1, 2),
                 "gspmd": (1, 2), "*": (1,)},
    "stage": {"fused": ("f32", "bf16"), "*": ("f32",)},
    #: Round 18: EnKF-cycled forecast plans — the da marker on the
    #: single-device batched tiers (the rules prune it everywhere
    #: else: da needs B >= 2, k = 1, f32).
    "da": {"fused": (False, True), "classic": (False, True),
           "*": (False,)},
    #: Serving sub-space: placement modes explored at the packed B=2
    #: bucket ('off' = the single-chip round-11 path).
    "placement": ("off", "member", "panel"),
}


def _axis(axes, name, tier):
    spec = axes[name]
    if isinstance(spec, dict):
        return spec.get(tier, spec["*"])
    return spec


def enumerate_plans(n: int = 12, halo: int = 2, axes=None,
                    include_serving: bool = True):
    """Walk the rule table: the complete legal plan space at ``(n,
    halo)`` over :data:`DEFAULT_AXES` (or ``axes``).

    Candidates that a ``requires``/``excludes`` edge forbids are
    dropped; candidates an ``implies`` edge would rewrite are dropped
    as non-canonical duplicates (their canonical twin is already in
    the walk).  The result is deterministic and sorted by plan key.
    """
    from .plan import CapabilityPlan

    axes = axes or DEFAULT_AXES
    out = {}
    for tier in axes["tier"]:
        for ov, tb, B, stage, da in itertools.product(
                _axis(axes, "overlap", tier),
                _axis(axes, "temporal_block", tier),
                _axis(axes, "ensemble", tier),
                _axis(axes, "stage", tier),
                _axis(axes, "da", tier)):
            p = CapabilityPlan(
                tier=tier, n=n, halo=halo, overlap=ov,
                temporal_block=tb, ensemble=B, stage=stage,
                strips=stage, da=da,
                num_devices=(6 if tier in ("face", "gspmd",
                                           "tt_sharded") else 1),
                use_shard_map=tier in ("face", "tt_sharded"),
                backend=("pallas" if tier == "fused" else "jnp"),
                covariant=tier != "tt" and tier != "tt_sharded",
            )
            if not is_canonical(p):
                continue
            if check_plan(p):
                continue
            out[p.key()] = p
    if include_serving:
        # (placement -> tier): 'off' packs on one device and runs
        # either the vmapped classic or (grouped) the fused
        # member-fold masked segment; 'member' is the GSPMD
        # member-parallel program; 'panel' the shard_map face tier.
        serve_tiers = {"off": ("classic", "fused"),
                       "member": ("gspmd",), "panel": ("face",)}
        for placement in axes["placement"]:
            for tier in serve_tiers[placement]:
                p = CapabilityPlan(
                    tier=tier, n=n, halo=halo, ensemble=2,
                    serving=True, placement=placement,
                    serve_grouping=(placement == "panel"
                                    or tier == "fused"),
                    num_devices=(6 if placement == "panel" else
                                 2 if placement == "member" else 1),
                    backend=("pallas" if tier == "fused" else "jnp"),
                    covariant=True,
                )
                p = normalize(p)
                if check_plan(p):
                    continue
                out[p.key()] = p
    return [out[k] for k in sorted(out)]


def plan_space_keys(axes=None) -> frozenset:
    """The capability *class* keys of the default enumerated space
    (cached) — the coverage set proof stamps check membership against.
    Class keys are resolution-independent and mark the batched/blocked
    axes without exact counts, so the small enumeration grid stands
    for every resolution, member count and block length."""
    global _KEY_CACHE
    if axes is None:
        if _KEY_CACHE is None:
            _KEY_CACHE = frozenset(
                p.class_key() for p in enumerate_plans())
        return _KEY_CACHE
    return frozenset(p.class_key() for p in enumerate_plans(axes=axes))


_KEY_CACHE = None
