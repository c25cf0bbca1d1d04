"""The sharded steppers' dispatcher (counterpart of
:func:`jaxstream.parallel.sharded_model.make_stepper_for`).

Ported: the single-device branch (no setup, or a one-rank setup) —
the model's classic step, ``temporal_block`` steps per call, vmapped over
an ensemble's member axis — and the
explicit covariant branch (``use_shard_map: true`` with a covariant
model) — the face tier on a ``(6, 1, 1)`` mesh (with ``nu4``), the
block tier on ``(6, s, s)`` (``nu4 = 0``), both in every
reconstruction.  Everything else the JAX dispatcher builds raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from .shard_cov import not_ported

__all__ = ["make_stepper_for"]

def make_stepper_for(model, setup, example_state, dt: float,
                     scheme: str = "ssprk3", temporal_block: int = None,
                     ensemble: int = 0, precision=None):
    """The stepper of ``setup``'s tier: ``step(state, t) -> state``.

    With no setup (or a one-rank setup) this is the single-device
    classic step ``model.make_step(dt, scheme)`` over the global state;
    ``temporal_block = k > 1`` fuses k of them into one call
    (:func:`~jaxstream_torch.stepping.blocked`, exact) and sets
    ``step.steps_per_call``.  On the explicit tiers the state is
    :func:`~.mesh.shard_state`'s stacked local state, and
    ``temporal_block`` (default: the setup's) sets the steps per call on
    the block tier.  ``example_state`` is accepted for the JAX package's
    signature and not read.
    """
    del example_state
    from ..ops.cuda.precision import resolve_stage_precision

    if resolve_stage_precision(precision) is not None:
        not_ported(f"precision={precision!r} (a non-f32 stage policy on "
                   "the sharded tiers)")
    k = (getattr(setup, "temporal_block", 1) if temporal_block is None
         else temporal_block)
    if setup is None or setup.ranks is None:
        step = model.make_step(dt, scheme)
        if ensemble:
            # The single-device ensemble: the classic step over the member
            # axis (ENSEMBLE_STATE_AXES' rule: vector fields keep their
            # component axis first, member second; scalars lead with it).
            from ..stepping import vmap_ensemble

            axes = {kk: (1 if kk in ("u", "v") else 0)
                    for kk in ("h", "u", "v", "q", "T")}
            step = vmap_ensemble(step, axes)
        if k > 1:
            from ..stepping import blocked

            step = blocked(step, k, dt)
            step.steps_per_call = k
        return step
    if not setup.use_shard_map:
        not_ported("the GSPMD path of make_stepper_for "
                   "(use_shard_map: false)")
    if not hasattr(model, "exchange_u"):
        not_ported("the Cartesian shard path (make_sharded_stepper)")
    if scheme != "ssprk3":
        raise ValueError(f"the explicit covariant shard path implements "
                         f"ssprk3 only; got scheme={scheme!r}")
    if ensemble:
        not_ported(f"ensemble={ensemble} on the sharded tiers (the "
                   "ensemble stepper and the batched exchange)")
    from .shard_cov import make_sharded_cov_stepper
    from .shard_cov_block import make_sharded_cov_block_stepper

    if setup.panel == 6 and setup.sy == setup.sx and setup.sy > 1:
        return make_sharded_cov_block_stepper(model, setup, dt,
                                              temporal_block=k)
    return make_sharded_cov_stepper(model, setup, dt, temporal_block=k)
