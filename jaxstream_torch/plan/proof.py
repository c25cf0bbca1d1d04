"""Proof stamps: every built stepper carries its verification verdict.

Counterpart of :mod:`jaxstream.plan.proof`, whose code this module keeps
as it is (pure Python in both packages; the port keeps its own copy, so
that it imports nothing of the JAX package). Names, record kinds,
messages and outputs are the JAX module's.

A :class:`ProofStamp` is the machine-checked provenance of one built
stepper: which capability plan it implements (:attr:`plan_key`), the
canonical race-free schedule digest its exchanges must realize
(:attr:`schedule_fingerprint` — None for tiers with no explicit
collectives), the rule-table version the legality check ran against
(:attr:`rules_version`), and the verdict:

* ``"verified"`` — the plan passed the rule table AND its capability
  key is inside the enumerated plan space
  (:func:`jaxstream.plan.rules.plan_space_keys`), which
  ``jaxstream.analysis.contracts`` traces and jaxpr-audits wholesale
  (collective counts vs analytic plans, overlap windows, dtype
  census, callback/donation invariants) in every tier-1 gate.
* ``"schedule_verified"`` — tiers the in-process device pool cannot
  trace (the 24-device block mesh): the pure exchange-schedule pass
  still proves their programs against the seam graph; the jaxpr-level
  audit is out of reach by construction.
* ``"rules_only"`` — legal by the table but outside the enumerated
  axes (e.g. an exotic axis value): the stamp says so loudly instead
  of implying coverage that does not exist.

The serve telemetry manifest, the bucket stamps and the crash bundle
surface these fields.  The port has the stamp and :func:`build_proof`;
``attach_proof`` and ``verify_stamp`` (the analyzer's cross-check
against a traced schedule) wait for ``plan/build.py`` and the analysis
package (ROADMAP queue A item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from . import rules

__all__ = ["ProofStamp", "build_proof"]


@dataclasses.dataclass(frozen=True)
class ProofStamp:
    plan_key: str
    schedule_fingerprint: Optional[str]
    rules_version: int
    jaxpr_audit: str     # 'matrix' | 'schedule_only' | 'uncovered'
    verdict: str         # 'verified' | 'schedule_verified' | 'rules_only'

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self):
        fp = self.schedule_fingerprint or "-"
        return (f"proof[{self.plan_key}] sched={fp} "
                f"rules=v{self.rules_version} audit={self.jaxpr_audit} "
                f"verdict={self.verdict}")


def build_proof(plan) -> ProofStamp:
    """Stamp one (already rule-checked) plan.

    Raises :class:`~jaxstream.plan.rules.PlanError` if the plan is in
    fact illegal — a stamp can never be minted for a plan the table
    rejects.
    """
    plan = rules.reject_illegal(plan)
    key = plan.key()
    if plan.tier in rules.SCHEDULE_ONLY_TIERS:
        audit, verdict = "schedule_only", "schedule_verified"
    elif plan.class_key() in rules.plan_space_keys():
        audit, verdict = "matrix", "verified"
    else:
        audit, verdict = "uncovered", "rules_only"
    return ProofStamp(
        plan_key=key,
        schedule_fingerprint=plan.schedule_fingerprint(),
        rules_version=rules.RULES_VERSION,
        jaxpr_audit=audit, verdict=verdict)
