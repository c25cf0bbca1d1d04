"""The YAML run schema and its loader (counterpart of
:mod:`jaxstream.config`).

Every section of the JAX package's schema, with the same fields and
defaults, so that one config file drives either package and is accepted
or refused by both alike.  Sections that only later parts of the port
read (ensemble, observability, precision, serve, da) are parsed and
validated all the same; :class:`~jaxstream_torch.simulation.Simulation`
refuses the knobs it does not run yet, naming their ROADMAP item.

YAML is read by :mod:`jaxstream_torch._yaml` (the subset the configs are
written in), so the port needs no PyYAML.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any

from . import _yaml

__all__ = [
    "GridConfig",
    "ParallelConfig",
    "PhysicsConfig",
    "ModelConfig",
    "TimeConfig",
    "AsyncPipelineConfig",
    "IOConfig",
    "EnsembleConfig",
    "ObservabilityConfig",
    "PrecisionConfig",
    "PlacementConfig",
    "ServeConfig",
    "DAConfig",
    "Config",
    "load_config",
]

EARTH_RADIUS = 6.37122e6
EARTH_OMEGA = 7.292e-5
EARTH_GRAVITY = 9.80616


@dataclasses.dataclass(frozen=True)
class GridConfig:
    n: int = 48                      # cells per panel edge (C{n})
    halo: int = 2                    # >=2 for PLR, >=3 for PPM
    radius: float = EARTH_RADIUS
    dtype: str = "float32"
    metrics: str = "eager"           # 'eager' | 'lazy'


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """The ``parallelization`` block, with the JAX package's defaults.

    ``device_type`` keeps the JAX package's names and is a name only:
    ``'cpu'`` is its virtual-device tier, whose counterpart here is
    virtual ranks in one process
    (:func:`jaxstream_torch.parallel.mesh.setup_sharding` with no process
    group), on the device the caller gives (the GPU unless it asks for
    the CPU).  ``use_shard_map`` selects the explicit tiers,
    ``overlap_exchange`` their interior/band split, ``temporal_block``
    the steps per stepper call.  ``donate_state`` is accepted and does
    nothing: PyTorch has no buffer donation, and an eager loop holds no
    reference to a state it has replaced.
    """

    tiles_per_edge: int = 1
    num_devices: int = 6
    device_type: str = "cpu"
    use_shard_map: bool = False
    overlap_exchange: bool = False
    donate_state: bool = True
    temporal_block: int = 1


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    gravity: float = EARTH_GRAVITY
    omega: float = EARTH_OMEGA
    hyperdiffusion: float = 0.0      # nu4 coefficient (m^4/s)
    divergence_damping: float = 0.0  # nondimensional d2 coefficient
    diffusivity: float = 1.0e5       # kappa (m^2/s) for the diffusion model


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "auto"               # 'auto' | 'shallow_water' | 'shallow_water_cov' | 'advection' | 'diffusion'
    initial_condition: str = "tc2"   # tc1/cosine_bell | checkerboard | tc2 | tc5 | tc6 | galewsky
    scheme: str = "plr"              # 'plr' | 'ppm' reconstruction
    limiter: str = "mc"              # 'minmod' | 'mc' | 'vanleer' | 'mc_sign' | 'none'
    backend: str = "jnp"             # 'jnp' | 'pallas' | 'pallas_interpret'
    ic_angle: float = 0.0            # flow-orientation angle (TC1/TC2 alpha)
    numerics: str = "dense"          # 'dense' | 'tt' (not ported yet)
    tt_rank: int = 16
    tt_kappa: float = 0.0
    tt_rounding: str = "auto"        # 'auto' | 'aca' | 'svd'
    nu4_mode: str = "split"          # 'split' | 'refused' | 'stage'


@dataclasses.dataclass(frozen=True)
class TimeConfig:
    dt: float = 600.0
    scheme: str = "ssprk3"
    duration_days: float = 1.0       # total integration length ...
    nsteps: int = 0                  # ... or an explicit step count (wins if > 0)


@dataclasses.dataclass(frozen=True)
class AsyncPipelineConfig:
    """``io.async_pipeline:`` (the async host pipeline)."""
    enabled: bool = False
    max_pending_segments: int = 2


@dataclasses.dataclass(frozen=True)
class IOConfig:
    history_path: str = "history"
    history_stride: int = 0          # steps between snapshots; 0 = off
    history_tt_rank: int = 0         # >0: TT-compress snapshots (not ported)
    checkpoint_path: str = "checkpoints"
    checkpoint_stride: int = 0
    async_pipeline: AsyncPipelineConfig = AsyncPipelineConfig()


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    """Perturbed-IC ensemble block (``members > 1``: single-device runs
    only; the tiers' ensembles are not ported yet)."""
    members: int = 1
    seed: int = 0
    amplitude: float = 1.0e-3
    layout: str = "auto"             # 'auto' | 'panel_member' | 'member'


@dataclasses.dataclass(frozen=True)
class ObservabilityConfig:
    """In-loop run telemetry, its sink and the flight recorder's bundle
    directory."""
    metrics: str = "default"
    interval: int = 0
    sink: str = ""
    guards: str = "off"
    cfl_limit: float = 2.0
    fault_step: int = -1
    flight_dir: str = ""


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Per-stage dtype policy and carry encoding of the fused covariant
    stepper."""
    stage: str = "f32"               # 'f32' | 'bf16'
    strips: str = "auto"             # 'auto' | 'f32' | 'bf16'
    carry: str = "f32"               # 'f32' | 'bf16' | 'mixed16'


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """``serve.placement:`` (the serving stack is not ported yet)."""
    mode: str = "off"                # 'off' | 'member' | 'panel'
    num_devices: int = 0
    device_type: str = "cpu"


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """The continuous-batching server's block (not ported yet)."""
    buckets: str = "1,4,16"
    segment_steps: int = 8
    queue_capacity: int = 64
    output_dir: str = ""
    sink: str = ""
    guards: str = "evict"
    max_guard_events: int = 16
    fault_member: int = -1
    donate: bool = True
    trace: bool = False
    memory_watch: bool = False
    cost_stamps: bool = False
    group_by_orography: bool = False
    warm_pool: str = ""
    compile_cache: str = ""
    speculate: bool = False
    min_headroom_frac: float = 0.0
    placement: PlacementConfig = PlacementConfig()


@dataclasses.dataclass(frozen=True)
class DAConfig:
    """Ensemble data assimilation's block (not ported yet)."""
    cycles: int = 0
    cycle_steps: int = 8
    nstations: int = 64
    obs_seed: int = 7
    obs_sigma: float = 1.0
    inflation: float = 1.05
    localization_km: float = 0.0
    guards: str = "warn"
    spread_collapse_factor: float = 0.01
    divergence_ratio: float = 10.0
    sink: str = ""


@dataclasses.dataclass(frozen=True)
class Config:
    grid: GridConfig = GridConfig()
    parallelization: ParallelConfig = ParallelConfig()
    physics: PhysicsConfig = PhysicsConfig()
    model: ModelConfig = ModelConfig()
    time: TimeConfig = TimeConfig()
    io: IOConfig = IOConfig()
    ensemble: EnsembleConfig = EnsembleConfig()
    observability: ObservabilityConfig = ObservabilityConfig()
    precision: PrecisionConfig = PrecisionConfig()
    serve: ServeConfig = ServeConfig()
    da: DAConfig = DAConfig()


_SECTIONS = {
    "grid": GridConfig,
    "parallelization": ParallelConfig,
    "physics": PhysicsConfig,
    "model": ModelConfig,
    "time": TimeConfig,
    "io": IOConfig,
    "ensemble": EnsembleConfig,
    "observability": ObservabilityConfig,
    "precision": PrecisionConfig,
    "serve": ServeConfig,
    "da": DAConfig,
}

#: Dataclass-typed fields nested inside a section (config sub-blocks).
_NESTED_SECTIONS = {
    "AsyncPipelineConfig": AsyncPipelineConfig,
    "PlacementConfig": PlacementConfig,
}


def _suggest(unknown, valid) -> str:
    """Did-you-mean tail for unknown-key errors: the closest valid name
    per typo (difflib ratio)."""
    import difflib

    hints = []
    for k in sorted(unknown):
        close = difflib.get_close_matches(k, valid, n=1, cutoff=0.6)
        if close:
            hints.append(f"{k!r} -> did you mean {close[0]!r}?")
    return (" (" + "; ".join(hints) + ")") if hints else ""


def _build_section(cls, data: dict):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} keys {sorted(unknown)}; valid: "
            f"{sorted(fields)}{_suggest(unknown, fields)}"
        )
    # Coerce to the declared field types: YAML 1.1 reads an exponent
    # without a sign ("1.0e14") as a string, and users write "6" where
    # an int is declared — both must land as numbers.
    coerced = {}
    for k, v in data.items():
        ftype = fields[k].type
        ftype = getattr(ftype, "__name__", ftype)  # str or type object
        if ftype in _NESTED_SECTIONS:
            # Recurse outside the coercion try, so that a bad key inside
            # the sub-block surfaces its own message.
            nested = _NESTED_SECTIONS[ftype]
            if isinstance(v, nested):
                pass
            elif isinstance(v, dict) or v is None:
                v = _build_section(nested, v or {})
            else:
                raise ValueError(
                    f"{cls.__name__}.{k} expects a {ftype} mapping, "
                    f"got {v!r}"
                )
            coerced[k] = v
            continue
        try:
            if ftype == "float" and not isinstance(v, float):
                v = float(v)
            elif ftype == "int" and not isinstance(v, (int, bool)):
                v = int(v)
        except (TypeError, ValueError):
            raise ValueError(
                f"{cls.__name__}.{k} expects a {ftype}, got {v!r}"
            ) from None
        coerced[k] = v
    return cls(**coerced)


def load_config(source: Any = None) -> Config:
    """Build a Config from a YAML path, a YAML string, a dict, or None."""
    if source is None:
        return Config()
    if isinstance(source, Config):
        return source
    if isinstance(source, dict):
        data = source
    else:
        text = str(source)
        if os.path.exists(text):
            with open(text) as fh:
                data = _yaml.safe_load(fh.read()) or {}
        else:
            loaded = _yaml.safe_load(text)
            if not isinstance(loaded, dict):
                raise ValueError(
                    f"config source {text!r} is neither an existing file path "
                    f"nor a YAML mapping"
                )
            data = loaded
    kwargs = {}
    unknown = set(data) - set(_SECTIONS)
    if unknown:
        raise ValueError(
            f"unknown config sections {sorted(unknown)}; valid: "
            f"{sorted(_SECTIONS)}{_suggest(unknown, _SECTIONS)}"
        )
    for name, cls in _SECTIONS.items():
        if name in data:
            kwargs[name] = _build_section(cls, data[name] or {})
    return Config(**kwargs)
