"""Capability plans: the normalized layer between config and stepper.

Counterpart of :mod:`jaxstream.plan.plan`, whose code this module keeps
as it is (pure Python in both packages; the port keeps its own copy, so
that it imports nothing of the JAX package). Names, record kinds,
messages and outputs are the JAX module's.

``config -> plan_for() -> CapabilityPlan -> build -> stepper`` is the
single build pipeline (ROADMAP open item 3): a plan names the
execution *tier* a config resolves to plus every composition knob that
changes the compiled program — overlap, temporal blocking, the member
axis, the precision ladder, donation, serving placement.  Illegal
combinations are rejected by the declarative rule table
(:mod:`jaxstream.plan.rules`) **statically** — before any grid build,
any device placement, any trace — with the same pointer messages the
scattered legacy ``raise ValueError`` prose carried.

A plan knows its own verification contract: :meth:`key` is the
resolution-independent capability key the enumerated proof matrix is
indexed by, :meth:`schedule_fingerprint` pins the canonical race-free
exchange schedule for explicit-exchange tiers, and :meth:`parity`
declares the runtime parity budget (bitwise / cross-tier 1e-6 /
deep-halo truncation) that ``tests/test_plan.py`` generates its
assertions from.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import rules
from .rules import PlanError, reject_illegal

__all__ = ["CapabilityPlan", "plan_for", "PlanError"]

def _ic_family():
    from ..simulation import IC_FAMILY

    return IC_FAMILY


@dataclasses.dataclass(frozen=True)
class CapabilityPlan:
    """One resolved execution strategy.  Frozen: a plan is a value."""

    tier: str                      # see rules.TIERS
    n: int = 0                     # cells per panel edge
    halo: int = 2                  # effective halo (after scheme bump)
    scheme: str = "ssprk3"         # time scheme
    overlap: bool = False          # overlapped halo exchange
    temporal_block: int = 1        # k steps per compiled block
    ensemble: int = 1              # member-batch width (1 = single)
    layout: str = "auto"           # ensemble mesh layout
    stage: str = "f32"             # precision: stage arithmetic
    strips: str = "f32"            # precision: strip storage (resolved)
    carry: str = "f32"             # precision: carry storage
    nu4: bool = False              # hyperdiffusion active
    nu4_mode: str = "split"        # del^4 placement on the fused path
    donate: bool = True            # carry donation
    num_devices: int = 1
    tiles_per_edge: int = 1
    use_shard_map: bool = False
    backend: str = "jnp"           # model RHS backend
    covariant: bool = True         # covariant velocity formulation
    family: str = "shallow_water"  # IC-driven model family
    obs_interval: int = 0          # in-loop telemetry stride
    serving: bool = False          # a serve-bucket plan
    placement: str = "off"         # serve placement mode
    serve_grouping: bool = False   # serve.group_by_orography
    #: Round 18: an EnKF-cycled forecast plan (``da.cycles > 0``) —
    #: the in-process cycle's batched forecast stepper.  The analysis
    #: update is pure member-axis linear algebra OUTSIDE the stepper,
    #: so a da plan's compiled program is its ensemble twin's; the
    #: marker keys the coverage class the cycle's stamp is checked
    #: against (gateway-client cycles ride the serving plans instead).
    da: bool = False

    # -- derived predicates the rule table matches on ------------------
    @property
    def stage_policy_on(self) -> bool:
        return self.stage != "f32" or self.strips == "bf16"

    @property
    def precision_touched(self) -> bool:
        return (self.stage_policy_on or self.carry != "f32"
                or self.nu4_mode != "split")

    @property
    def deep_halo(self) -> int:
        return 3 * self.temporal_block * self.halo

    @property
    def fits_deep_halo(self) -> bool:
        return self.n == 0 or self.n >= self.deep_halo

    @property
    def obs_interval_aligned(self) -> bool:
        return (self.obs_interval <= 0
                or self.obs_interval % self.temporal_block == 0)

    # -- identity -------------------------------------------------------
    def _key(self, exact: bool) -> str:
        parts = []
        if self.serving:
            parts.append("serve_" + (self.placement
                                     if self.placement != "off"
                                     else "single"))
        parts.append(self.tier)
        if self.overlap:
            parts.append("ov")
        if self.temporal_block > 1:
            parts.append(f"tb{self.temporal_block}" if exact else "tb")
        if self.ensemble > 1 and not self.serving:
            parts.append(f"B{self.ensemble}" if exact else "B")
        if self.stage != "f32":
            parts.append(self.stage)
        if self.strips == "bf16" and self.stage != "bf16":
            # A strips-only 16-bit policy is its own program class
            # (quantized exchange payloads under f32 arithmetic) —
            # the key must not collapse it onto plain f32 coverage.
            parts.append("strips_bf16")
        if self.carry != "f32":
            parts.append("carry_" + self.carry)
        if self.da:
            parts.append("da")
        return "+".join(parts)

    def key(self) -> str:
        """Resolution-independent capability key — exact axis values
        (the display/identity form).  Composition axes only:
        within-tier numeric modes (nu4 placement, TT rounding tiers)
        are governed by runtime parity gates, not the static matrix
        (DESIGN.md "Capability plans")."""
        return self._key(exact=True)

    def class_key(self) -> str:
        """The capability *class* key the verified matrix is indexed
        by: batched (``B``) and blocked (``tb``) markers replace exact
        member/block counts — the analyzer proves each class at
        representative axis values (B=2, k=2); the count-scaling
        argument (one schedule x k, one payload x B) is structural.
        Serving plans drop the B token entirely: every bucket width
        runs the SAME masked-segment program."""
        return self._key(exact=False)

    def schedule_fingerprint(self) -> Optional[str]:
        """The canonical race-free schedule digest for tiers whose
        steppers issue the explicit 4-stage ppermute exchange; None
        for tiers with no explicit collectives (fused/classic, GSPMD
        inference, member-parallel serving)."""
        if (self.tier in rules.EXCHANGE_TIERS
                or (self.serving and self.placement == "panel")):
            from ..geometry.connectivity import schedule_fingerprint

            return schedule_fingerprint()
        return None

    def steps_per_call(self) -> int:
        return self.temporal_block

    # -- declared runtime-parity contract ------------------------------
    def parity(self) -> dict:
        """The runtime parity budget this plan declares, as
        ``{"reference": <capability key>, "budget": rel-err}`` —
        ``budget`` 0.0 means bitwise.  ``tests/test_plan.py`` GENERATES
        its parity assertions from this over the enumerated space,
        instead of hand-writing them per pair.  Budgets are the repo's
        established measured bands: overlap/member-batching/exact
        temporal fusion <= 1e-6 (shape-dependent XLA FMA contraction
        across jit boundaries), deep-halo temporal blocking at
        truncation level (~2e-3 measured C32), the TT tier's
        overlap/fusion bitwise."""
        base = dataclasses.replace(
            self, overlap=False, temporal_block=1, ensemble=1,
            stage="f32", strips="f32", carry="f32", serving=False,
            placement="off", serve_grouping=False, da=False)
        base = rules.normalize(base)
        if self == base:
            ref_key = None
        else:
            ref_key = base.key()
        budget = 0.0
        deep = (self.tier == "face" and self.temporal_block > 1
                and self.ensemble == 1)
        if deep:
            budget = 2e-3            # exchange-free seam recompute
        elif self.tier in ("tt", "tt_sharded"):
            budget = 0.0             # overlap/tb are bitwise on TT
        else:
            if self.overlap or self.ensemble > 1 or self.serving:
                budget = 1e-6
            if self.temporal_block > 1:
                # Exact k-step fusion is value-identical op-for-op,
                # but one fused executable may contract FMAs
                # differently than k separate dispatches — last-ulp
                # (<= 1e-6 rel), same band as the member axis.
                budget = max(budget, 1e-6)
            if self.stage != "f32" or self.carry != "f32":
                budget = max(budget, 7e-3)  # measured bf16 band
        return {"reference": ref_key, "budget": budget}

    def describe(self) -> dict:
        """JSON-able summary (the ``scripts/plan.py explain`` body)."""
        d = dataclasses.asdict(self)
        d["key"] = self.key()
        d["schedule_fingerprint"] = self.schedule_fingerprint()
        d["parity"] = self.parity()
        d["rules_version"] = rules.RULES_VERSION
        return d


def _resolve_tier(cfg, family: str, covariant: bool) -> str:
    m, par = cfg.model, cfg.parallelization
    multi = par.num_devices > 1
    if m.numerics == "tt":
        return "tt_sharded" if (multi or par.use_shard_map) else "tt"
    if multi and par.use_shard_map:
        if covariant:
            return ("face_block" if par.tiles_per_edge > 1
                    else "face")
        return "cartesian_shard"
    if multi:
        return "gspmd"
    # Single device: the Simulation fused-path gate, mirrored.
    members = cfg.ensemble.members
    nu4 = cfg.physics.hyperdiffusion != 0.0
    if (cfg.time.scheme == "ssprk3"
            and m.backend.startswith("pallas")
            and family == "shallow_water"):
        if members > 1:
            if covariant and not nu4:
                return "fused"
        elif not nu4 or covariant:
            return "fused"
    return "classic"


def plan_for(config, serving: bool = False) -> CapabilityPlan:
    """Resolve a config into its (normalized, rule-checked)
    :class:`CapabilityPlan` — raising :class:`PlanError` with the rule
    pointers when the composition is illegal.  Runs before any grid or
    model build: pure config arithmetic.

    ``serving=True`` resolves the config as an ``EnsembleServer``
    deployment (the ``serve:`` block's placement becomes the plan's
    placement; the bucket width is the largest configured bucket).
    """
    from ..config import load_config

    cfg = load_config(config)
    m, par, ens = cfg.model, cfg.parallelization, cfg.ensemble
    if ens.members < 1:
        raise PlanError([rules.RuleViolation(
            "ensemble-members-positive",
            f"ensemble.members must be >= 1, got {ens.members}")])
    if m.numerics not in ("dense", "tt"):
        raise PlanError([rules.RuleViolation(
            "numerics-enum",
            f"model.numerics={m.numerics!r}; valid: 'dense' "
            "(production solvers) or 'tt' (factored-panel tier)")])
    fam_map = _ic_family()
    family = fam_map.get(m.initial_condition)
    if family is None:
        raise PlanError([rules.RuleViolation(
            "unknown-initial-condition",
            f"unknown initial_condition {m.initial_condition!r}; "
            f"valid: {sorted(fam_map)}")])
    allowed = {"auto", family}
    if family == "shallow_water":
        allowed.add("shallow_water_cov")
    if m.name not in allowed and m.numerics == "dense":
        raise PlanError([rules.RuleViolation(
            "model-name-ic-compat",
            f"model.name={m.name!r} is incompatible with "
            f"initial_condition={m.initial_condition!r} (which drives "
            f"{family!r})")])
    p = cfg.precision
    if p.stage not in ("f32", "bf16"):
        raise PlanError([rules.RuleViolation(
            "precision-stage-enum",
            f"precision.stage={p.stage!r}; valid: 'f32', 'bf16'")])
    if p.strips not in ("auto", "f32", "bf16"):
        raise PlanError([rules.RuleViolation(
            "precision-strips-enum",
            f"precision.strips={p.strips!r}; valid: 'auto', 'f32', "
            "'bf16'")])
    if p.carry not in ("f32", "bf16", "mixed16"):
        raise PlanError([rules.RuleViolation(
            "precision-carry-enum",
            f"precision.carry={p.carry!r}; valid: 'f32', 'bf16', "
            "'mixed16'")])
    if m.nu4_mode not in ("split", "stage", "refused"):
        raise PlanError([rules.RuleViolation(
            "nu4-mode-enum",
            f"nu4_mode must be 'split', 'stage' or 'refused', got "
            f"{m.nu4_mode!r}")])

    covariant = m.name == "shallow_water_cov"
    halo = cfg.grid.halo
    if m.scheme == "ppm":
        halo = max(halo, 3)
    placement = cfg.serve.placement.mode if serving else "off"
    if serving and placement not in ("off", "member", "panel"):
        raise PlanError([rules.RuleViolation(
            "serve-placement-enum",
            f"serve.placement.mode={placement!r}; valid: "
            "('off', 'member', 'panel')")])
    if serving:
        try:
            buckets = [int(b) for b in
                       str(cfg.serve.buckets).split(",") if b.strip()]
        except ValueError:
            raise PlanError([rules.RuleViolation(
                "serve-buckets-parse",
                f"serve.buckets={cfg.serve.buckets!r} must be a "
                "comma-separated list of positive ints")]) from None
        if not buckets or min(buckets) < 1:
            raise PlanError([rules.RuleViolation(
                "serve-buckets-parse",
                f"serve.buckets={cfg.serve.buckets!r} must name at "
                "least one positive batch size")])
        members = max(buckets)
        tier = {"panel": "face", "member": "gspmd"}.get(
            placement, "classic")
        if (tier == "classic" and cfg.serve.group_by_orography
                and m.backend.startswith("pallas")
                and cfg.time.scheme == "ssprk3"
                and cfg.physics.hyperdiffusion == 0.0):
            # Mirror EnsembleServer._impls_for: grouped single-chip
            # buckets prefer the fused member-fold masked segment.
            tier = "fused"
        if cfg.model.numerics == "tt":
            tier = "tt"
    else:
        members = ens.members
        tier = _resolve_tier(cfg, family, covariant)

    plan = CapabilityPlan(
        tier=tier, n=cfg.grid.n, halo=halo, scheme=cfg.time.scheme,
        overlap=par.overlap_exchange,
        temporal_block=par.temporal_block, ensemble=members,
        layout=ens.layout, stage=p.stage,
        strips=(p.stage if p.strips == "auto" else p.strips),
        carry=p.carry, nu4=cfg.physics.hyperdiffusion != 0.0,
        nu4_mode=m.nu4_mode, donate=par.donate_state,
        num_devices=par.num_devices,
        tiles_per_edge=par.tiles_per_edge,
        use_shard_map=par.use_shard_map, backend=m.backend,
        covariant=covariant, family=family,
        obs_interval=cfg.observability.interval,
        serving=serving, placement=placement,
        serve_grouping=cfg.serve.group_by_orography,
        da=(cfg.da.cycles > 0 and not serving),
    )
    return reject_illegal(plan)
