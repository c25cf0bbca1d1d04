"""Capability plans (counterpart of :mod:`jaxstream.plan`).

The rule table (:mod:`.rules`), the plan value and its resolution from a
config (:mod:`.plan`) and the proof stamp (:mod:`.proof`): pure config
arithmetic, copied from the JAX package with the same ``RULES_VERSION``,
plan keys and refusal texts.  The server raises its refusals and stamps
its buckets through them; the port's model raises its fused-step
refusals through :func:`.rules.fail`.  ``plan/build.py``, ``attach_proof``
and ``verify_stamp`` wait for ROADMAP queue A item 7.
"""

from .plan import CapabilityPlan, PlanError, plan_for
from .proof import ProofStamp, build_proof
from .rules import (RULES, RULES_VERSION, check_plan, enumerate_plans,
                    plan_space_keys, reject_illegal)

__all__ = [
    "CapabilityPlan", "PlanError", "plan_for",
    "ProofStamp", "build_proof",
    "RULES", "RULES_VERSION", "check_plan", "enumerate_plans",
    "plan_space_keys", "reject_illegal",
]
