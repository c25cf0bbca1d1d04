"""The sharded steppers' dispatcher (counterpart of
:func:`jaxstream.parallel.sharded_model.make_stepper_for`).

Ported: the explicit covariant branch (``use_shard_map: true`` with a
covariant model) — the face tier on a ``(6, 1, 1)`` mesh, the block tier
on ``(6, s, s)``.  Everything else the JAX dispatcher builds raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from .shard_cov import not_ported

__all__ = ["make_stepper_for"]

_F32_POLICIES = (None, "f32", "off", "none", "")


def make_stepper_for(model, setup, example_state, dt: float,
                     scheme: str = "ssprk3", temporal_block: int = None,
                     ensemble: int = 0, precision=None):
    """The stepper of ``setup``'s tier: ``step(state, t) -> state`` over
    :func:`~.mesh.shard_state`'s stacked local state.

    ``temporal_block`` (default: the setup's) sets the steps per call on
    the block tier (``step.steps_per_call`` when > 1).  ``example_state``
    is accepted for the JAX package's signature; the explicit tiers do
    not read it.
    """
    del example_state
    if not (precision in _F32_POLICIES
            or (isinstance(precision, str)
                and precision.lower() in _F32_POLICIES)):
        not_ported(f"precision={precision!r} (a non-f32 stage policy)")
    k = (getattr(setup, "temporal_block", 1) if temporal_block is None
         else temporal_block)
    if setup is None or not setup.use_shard_map:
        not_ported("the GSPMD and single-device paths of make_stepper_for "
                   "(use_shard_map: false)")
    if not hasattr(model, "exchange_u"):
        not_ported("the Cartesian shard path (make_sharded_stepper)")
    if scheme != "ssprk3":
        raise ValueError(f"the explicit covariant shard path implements "
                         f"ssprk3 only; got scheme={scheme!r}")
    if ensemble:
        not_ported(f"ensemble={ensemble} (the ensemble stepper and the "
                   "batched exchange)")
    if float(getattr(model, "nu4", 0.0)) != 0.0:
        not_ported("nu4 != 0 on the sharded covariant tiers")
    if (model.scheme, model.limiter) != ("plr", "mc"):
        not_ported(f"scheme={model.scheme!r}, limiter={model.limiter!r} on "
                   "the sharded covariant tiers (their kernels B4's stacked "
                   "form, B5 and B6 run PLR-MC)")
    from .shard_cov import make_sharded_cov_stepper
    from .shard_cov_block import make_sharded_cov_block_stepper

    if setup.panel == 6 and setup.sy == setup.sx and setup.sy > 1:
        return make_sharded_cov_block_stepper(model, setup, dt,
                                              temporal_block=k)
    return make_sharded_cov_stepper(model, setup, dt, temporal_block=k)
