"""Per-stage precision policy of the fused covariant stage kernels
(counterpart of :mod:`jaxstream.ops.pallas.precision`).

``compute='bf16'``: the stage kernels' flux face-average velocities, the
PLR limiter algebra and the strip router's rotation multiplies run in
bfloat16; accumulators, metric terms and the reconstruction's base values
stay float32.  ``strips='bf16'``: the inter-stage boundary strips and
routed ghosts are stored bfloat16 and widened to float32 where a kernel
reads them.  ``precision=None`` everywhere means off, and off is the
float32 path, bitwise.  Same policies, names and error messages as the
JAX package, with torch dtypes.
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["StagePrecision", "resolve_stage_precision", "encode_strips",
           "strip_dtype_bytes", "mixed16_encoding"]

_COMPUTE = ("f32", "bf16")
_STRIPS = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class StagePrecision:
    """Resolved per-stage dtype policy.

    ``compute``: 'f32' | 'bf16' — flux/reconstruction/router arithmetic.
    ``strips``:  'f32' | 'bf16' — inter-stage strip/ghost storage.
    """

    compute: str = "f32"
    strips: str = "f32"

    def __post_init__(self):
        if self.compute not in _COMPUTE:
            raise ValueError(
                f"StagePrecision.compute must be one of {_COMPUTE}, "
                f"got {self.compute!r}")
        if self.strips not in _STRIPS:
            raise ValueError(
                f"StagePrecision.strips must be one of {_STRIPS}, "
                f"got {self.strips!r}")

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.compute == "bf16" else torch.float32

    @property
    def strips_dtype(self):
        return torch.bfloat16 if self.strips == "bf16" else torch.float32

    @property
    def is_off(self) -> bool:
        return self.compute == "f32" and self.strips == "f32"


def resolve_stage_precision(precision) -> StagePrecision | None:
    """Normalize a precision spec to a policy, or None (off).

    Accepts ``None`` / ``'f32'`` (off), ``'bf16'`` (bf16 compute + bf16
    strips), a :class:`StagePrecision`, or a ``{'stage'|'compute': ...,
    'strips': ...}`` mapping (``strips='auto'`` follows the compute
    policy).  Returns ``None`` whenever the resolved policy is all f32.
    """
    if precision is None:
        return None
    if isinstance(precision, StagePrecision):
        return None if precision.is_off else precision
    if isinstance(precision, str):
        name = precision.lower()
        if name in ("f32", "off", "none", ""):
            return None
        if name == "bf16":
            return StagePrecision(compute="bf16", strips="bf16")
        raise ValueError(
            f"unknown precision policy {precision!r}; valid: 'f32', "
            "'bf16', a StagePrecision, or a {'stage','strips'} mapping")
    if isinstance(precision, dict):
        unknown = set(precision) - {"stage", "compute", "strips"}
        if unknown:
            raise ValueError(
                f"unknown precision keys {sorted(unknown)}; valid: "
                "'stage' (or 'compute') and 'strips'")
        compute = precision.get("stage", precision.get("compute", "f32"))
        strips = precision.get("strips", "auto")
        if strips == "auto":
            strips = compute
        return resolve_stage_precision(
            StagePrecision(compute=compute, strips=strips))
    raise TypeError(
        f"precision must be None/str/dict/StagePrecision, "
        f"got {type(precision).__name__}")


def _strip_keys(y):
    return [k for k in ("strips_sn", "strips_we") if k in y]


def encode_strips(y, precision):
    """Narrow a compact carry's strips to the policy's strips dtype
    (identity for f32 strips or a carry without strips); h and u are
    untouched."""
    pol = resolve_stage_precision(precision)
    if pol is None or pol.strips != "bf16":
        return y
    sdt = pol.strips_dtype
    keys = _strip_keys(y)
    return {k: (v.to(sdt) if k in keys else v) for k, v in y.items()}


def strip_dtype_bytes(precision) -> int:
    """Bytes per strip element under a policy (4 = f32, 2 = bf16)."""
    pol = resolve_stage_precision(precision)
    return 2 if (pol is not None and pol.strips == "bf16") else 4


def mixed16_encoding(h):
    """The mixed16 carry triple of an initial h field, ``(carry_dtype,
    h_offset, h_scale)``: h int16 fixed-point in 1/16 m quanta about the
    field's mid-range, u bf16."""
    off = float(0.5 * (float(torch.min(h)) + float(torch.max(h))))
    return (torch.int16, torch.bfloat16), off, 0.0625
