"""The stage precision policy and filter cycling, the port against the JAX
package, on the CPU.

    python scripts/torch_precision_probe.py [tc5|cycling|split16|galewsky6 ...]

* ``tc5``: Williamson TC5 at C24, 8 compact steps of dt = 300 s: each
  package's bf16 trajectory against its f32 one, and the port's against
  the JAX package's (both f32 and bf16), as max |diff| / max of h and u.
* ``cycling``: the Galewsky jet at C24 with nu4 scaled by (384 / 24)^3,
  so that the filter's coefficient over dx^4 is C384's at nu4 = 1e14 and
  the CFL-matched dt (60 * 16 s): the split del^4 stepper at
  ``interval`` 1 and 2 in both packages (the JAX one in interpret mode),
  and the first step whose h is not finite (up to 120).
* ``split16``: the Galewsky jet at C16, five split del^4 steps under the
  bf16 policy: the port's stepper (its sym rows un-prescaled, as the JAX
  package routes them for this stepper) and the prescaled form against
  the JAX package's, as max |diff| / max of h and u after each step.
* ``galewsky6``: the Galewsky jet at C96 to day 6 (dt and nu4 scaled
  from C384's as for ``cycling``), the split and re-fused del^4 steppers
  at f32 and under the bf16 policy, in both packages (the JAX one in
  interpret mode): bench_galewsky's gate figures (h range, mass drift,
  max |zeta| north and south of +-0.2 rad) and, for bf16, the largest
  |zeta_bf16 - zeta_f32| in the south, where the jet's flow is at rest.

Prints one line per measurement.  Needs both packages (the repository's
test environment).
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from jaxstream.config import (EARTH_GRAVITY as G, EARTH_OMEGA as OM,  # noqa: E402
                              EARTH_RADIUS as R)
from jaxstream.geometry.cubed_sphere import build_grid as jax_grid  # noqa: E402
from jaxstream.models.shallow_water_cov import (  # noqa: E402
    CovariantShallowWater as JaxCov)
from jaxstream.ops.fv import vorticity_cov as jax_vort  # noqa: E402
from jaxstream.ops.pallas import swe_cov as jsc  # noqa: E402
from jaxstream.ops.pallas.precision import encode_strips as jenc  # noqa: E402
from jaxstream.physics import initial_conditions as jic  # noqa: E402

from jaxstream_torch.geometry.cubed_sphere import build_grid  # noqa: E402
from jaxstream_torch.interop import to_torch  # noqa: E402
from jaxstream_torch.models.shallow_water_cov import (  # noqa: E402
    CovariantShallowWater)
from jaxstream_torch.ops.cuda import swe_cov as tsc  # noqa: E402
from jaxstream_torch.ops.cuda.precision import encode_strips  # noqa: E402
from jaxstream_torch.ops.fv import vorticity_cov  # noqa: E402
from jaxstream_torch.physics import initial_conditions as tic  # noqa: E402


def rel(a, b) -> float:
    a = np.asarray(jnp.asarray(a).astype(jnp.float64)) if not isinstance(
        a, torch.Tensor) else a.double().numpy()
    b = np.asarray(jnp.asarray(b).astype(jnp.float64)) if not isinstance(
        b, torch.Tensor) else b.double().numpy()
    return float(np.abs(a - b).max() / np.abs(a).max())


def tc5() -> None:
    n, dt, steps = 24, 300.0, 8
    jg = jax_grid(n, halo=2, radius=R, dtype=jnp.float32)
    jh, jv, jb = jic.williamson_tc5(jg, G, OM)
    jm = JaxCov(jg, gravity=G, omega=OM, b_ext=jb,
                backend="pallas_interpret")
    g = build_grid(n, halo=2, radius=R, device="cpu")
    h, v, b = tic.williamson_tc5(g, G, OM)
    m = CovariantShallowWater(g, gravity=G, omega=OM, b_ext=b)
    jy0 = jm.compact_state(jm.initial_state(jh, jv))
    y0 = m.compact_state(m.initial_state(h, v))
    runs = {}
    for pol in (None, "bf16"):
        js = jax.jit(jm.make_fused_step(dt, precision=pol))
        st = m.make_fused_step(dt, precision=pol)
        jy = jenc(jy0, pol) if pol else jy0
        y = encode_strips(y0, pol) if pol else y0
        for _ in range(steps):
            jy, y = js(jy, 0.0), st(y, 0.0)
        runs[pol] = (jy, y)
    (jf, tf), (jb16, tb16) = runs[None], runs["bf16"]
    for k in ("h", "u"):
        print(f"tc5 C{n} {steps} steps {k}: JAX bf16 vs f32 "
              f"{rel(jf[k], jb16[k]):.3e}; port bf16 vs f32 "
              f"{rel(tf[k], tb16[k]):.3e}; port vs JAX: bf16 "
              f"{rel(jb16[k], tb16[k]):.3e}, f32 {rel(jf[k], tf[k]):.3e}")


def cycling() -> None:
    n = 24
    dt, nu4 = 60.0 * 384 / n, 1.0e14 * (384 / n) ** 3
    jg = jax_grid(n, halo=2, radius=R, dtype=jnp.float32)
    jm = JaxCov(jg, gravity=G, omega=OM, nu4=nu4,
                backend="pallas_interpret")
    g = build_grid(n, halo=2, radius=R, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=nu4)
    for interval in (1, 2):
        js = jax.jit(jsc.make_fused_ssprk3_cov_split_nu4(
            jg, G, OM, dt, jm.b_ext, nu4, interpret=True,
            interval=interval))
        ts = tsc.make_fused_ssprk3_cov_split_nu4(g, G, OM, dt, m.b_ext, nu4,
                                                 interval=interval)
        jy = jm.compact_state(jm.initial_state(*jic.galewsky(jg, G, OM)))
        y = m.compact_state(m.initial_state(*tic.galewsky(g, G, OM)))
        if interval > 1:
            jy, y = dict(jy, filter_k=jnp.int32(0)), dict(y, filter_k=0)
        bad = {"JAX": None, "port": None}
        for i in range(1, 121):
            jy, y = js(jy, 0.0), ts(y, 0.0)
            if bad["JAX"] is None and not bool(jnp.all(jnp.isfinite(
                    jy["h"]))):
                bad["JAX"] = i
            if bad["port"] is None and not bool(torch.isfinite(
                    y["h"]).all()):
                bad["port"] = i
            if None not in bad.values():
                break
        print(f"cycling C{n} nu4 {nu4:.4g} dt {dt:g} interval {interval}: "
              + ", ".join(f"{k} first non-finite step "
                          f"{v if v is not None else '> 120'}"
                          for k, v in bad.items()))


def split16() -> None:
    n = 16
    dt = 60.0 * 384 / n
    jg = jax_grid(n, halo=2, radius=R, dtype=jnp.float32)
    jm = JaxCov(jg, gravity=G, omega=OM, nu4=1.0e14,
                backend="pallas_interpret")
    g = build_grid(n, halo=2, radius=R, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=1.0e14)
    js = jax.jit(jm.make_fused_step(dt, precision="bf16"))
    port = m.make_fused_step(dt, precision="bf16")
    adv = tsc.make_fused_ssprk3_cov_compact(g, G, OM, dt, m.b_ext,
                                            precision="bf16")
    filt = tsc.make_cov_nu4_filter(g, 1.0e14, dt, precision="bf16")

    def prescaled(y, t):
        y = adv(y, t)
        out = filt(y["h"], y["u"], *adv.route(y["strips_sn"],
                                              y["strips_we"]))
        return dict(zip(("h", "u", "strips_sn", "strips_we"), out))

    jy0 = jenc(jm.compact_state(jm.initial_state(*jic.galewsky(jg, G, OM))),
               "bf16")
    y0 = to_torch(jy0, device="cpu")
    for label, st in (("JAX form", port), ("prescaled", prescaled)):
        jy, y = jy0, y0
        line = []
        for i in range(1, 6):
            one = st(to_torch(jy, device="cpu"), 0.0)
            jy, y = js(jy, 0.0), st(y, 0.0)
            line.append(f"{i}: h {rel(jy['h'], y['h']):.2e} u "
                        f"{rel(jy['u'], y['u']):.2e} (one step from JAX's "
                        f"state h {rel(jy['h'], one['h']):.2e} u "
                        f"{rel(jy['u'], one['u']):.2e})")
        print(f"split16 C{n} bf16 {label} vs JAX: " + "; ".join(line))


def galewsky6(n: int = 96) -> None:
    dt, nu4 = 60.0 * 384 / n, 1.0e14 * (384 / n) ** 3
    steps = round(6 * 86400.0 / dt)
    jg = jax_grid(n, halo=2, radius=R, dtype=jnp.float32)
    jm = JaxCov(jg, gravity=G, omega=OM, nu4=nu4,
                backend="pallas_interpret")
    g = build_grid(n, halo=2, radius=R, device="cpu")
    m = CovariantShallowWater(g, gravity=G, omega=OM, nu4=nu4)
    area = g.interior(g.area).double().numpy()
    lat = g.interior(g.lat).numpy()
    jy0 = jm.compact_state(jm.initial_state(*jic.galewsky(jg, G, OM)))
    y0 = m.compact_state(m.initial_state(*tic.galewsky(g, G, OM)))
    mass0 = float((area * y0["h"].double().numpy()).sum())
    for mode in ("split", "refused"):
        kw = {} if mode == "split" else {"nu4_mode": "refused"}
        zeta_f32 = {}
        for pol in (None, "bf16"):
            js = jax.jit(jm.make_fused_step(dt, precision=pol, **kw))
            st = m.make_fused_step(dt, precision=pol, **kw)
            jy = jenc(jy0, pol) if pol else jy0
            y = encode_strips(y0, pol) if pol else y0
            for _ in range(steps):
                jy, y = js(jy, 0.0), st(y, 0.0)
            for pkg, h, zeta in (
                    ("JAX", np.asarray(jy["h"], np.float64), np.asarray(
                        jax_vort(jg, jm._fill_u(jy["u"])), np.float64)),
                    ("port", y["h"].double().numpy(), vorticity_cov(
                        g, m._fill_u(y["u"])).double().numpy())):
                drift = abs(float((area * h).sum()) - mass0) / mass0
                z = np.abs(zeta)
                line = (f"galewsky6 C{n} {mode} {pol or 'f32'} {pkg}: day 6 "
                        f"({steps} steps of {dt:g} s, nu4 {nu4:.4g}) "
                        f"finite={bool(np.isfinite(h).all())} h_range="
                        f"[{h.min():.1f}, {h.max():.1f}] mass_drift "
                        f"{drift:.3e} max|zeta| N {z[lat > 0.2].max():.3e} "
                        f"S {z[lat < -0.2].max():.3e}")
                if pol is None:
                    zeta_f32[pkg] = zeta
                else:
                    d = np.abs(zeta - zeta_f32[pkg])[lat < -0.2].max()
                    line += f"; max|zeta - zeta_f32| S {d:.3e}"
                print(line, flush=True)


def main(argv) -> int:
    parts = argv or ["tc5", "cycling", "split16", "galewsky6"]
    for part in parts:
        {"tc5": tc5, "cycling": cycling, "split16": split16,
         "galewsky6": galewsky6}[part]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
