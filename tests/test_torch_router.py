"""Port parity: the strip carry and the split strip router.

The ghost blocks of ``h`` are a pure gather and must match the JAX
router bit for bit.  The rotated ``u`` blocks and the sqrtg-prescaled
symmetrized edge-normal rows are products and sums: XLA on the CPU may
contract ``a*b + c*d`` into a fused multiply-add and evaluates ``rsqrt``
its own way, so those are held to 2 float32 ulp of each block's scale.
"""

import numpy as np
import torch

import jax.numpy as jnp

from jaxstream.config import EARTH_RADIUS
from jaxstream.geometry.cubed_sphere import build_grid as jax_build_grid
from jaxstream.ops.pallas import swe_cov as jcov

from jaxstream_torch.geometry.cubed_sphere import build_grid
from jaxstream_torch.ops.cuda import swe_cov as tcov

EPS32 = float(np.finfo(np.float32).eps)


def _setup(n=8, seed=0):
    jg = jax_build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=jnp.float32)
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32,
                    device="cpu")
    rng = np.random.default_rng(seed)
    h = 2
    sn = rng.standard_normal((6, 6 * h, n)).astype(np.float32)
    we = rng.standard_normal((6, n, 6 * h)).astype(np.float32)
    return jg, tg, sn, we


def _within_ulps(a, b, ulps=2):
    scale = float(np.max(np.abs(a)))
    return float(np.max(np.abs(a - b))) <= ulps * EPS32 * scale


def test_pack_strips_cov_split_bitwise():
    rng = np.random.default_rng(5)
    n, h = 8, 2
    hi = rng.standard_normal((6, n, n)).astype(np.float32)
    ui = rng.standard_normal((2, 6, n, n)).astype(np.float32)
    jsn, jwe = jcov.pack_strips_cov_split(jnp.asarray(hi), jnp.asarray(ui),
                                          n, h)
    tsn, twe = tcov.pack_strips_cov_split(torch.from_numpy(hi),
                                          torch.from_numpy(ui), n, h)
    assert np.array_equal(np.asarray(jsn), tsn.numpy())
    assert np.array_equal(np.asarray(jwe), twe.numpy())


def test_router_matches_jax():
    jg, tg, sn, we = _setup()
    h = 2
    jgsn, jgwe = jcov.make_cov_strip_router_split(jg, prescale_sym=True)(
        jnp.asarray(sn), jnp.asarray(we))
    tgsn, tgwe = tcov.make_cov_strip_router_split(tg)(
        torch.from_numpy(sn), torch.from_numpy(we))
    jgsn, jgwe = np.asarray(jgsn), np.asarray(jgwe)
    tgsn, tgwe = tgsn.numpy(), tgwe.numpy()
    assert jgsn.shape == tgsn.shape == (6, 6 * h + 2, 8)
    assert jgwe.shape == tgwe.shape == (6, 8, 6 * h + 2)
    assert tgwe.flags["C_CONTIGUOUS"]
    # h ghost blocks: a pure gather.
    assert np.array_equal(jgsn[:, :2 * h], tgsn[:, :2 * h])
    assert np.array_equal(jgwe[:, :, :2 * h], tgwe[:, :, :2 * h])
    # Rotated u blocks, per field.
    for fi in (1, 2):
        blk = slice(fi * 2 * h, (fi + 1) * 2 * h)
        assert _within_ulps(jgsn[:, blk], tgsn[:, blk]), fi
        assert _within_ulps(jgwe[:, :, blk], tgwe[:, :, blk]), fi
    # Prescaled symmetrized edge normals.
    assert _within_ulps(jgsn[:, 6 * h:], tgsn[:, 6 * h:])
    assert _within_ulps(jgwe[:, :, 6 * h:], tgwe[:, :, 6 * h:])


def test_router_seam_rows_are_shared_exactly():
    """Both faces of a physical edge receive the same sym value (up to
    the outward sign and the edge's reversal): the conservation
    invariant of the seam."""
    n = 8
    tg = build_grid(n, halo=2, radius=EARTH_RADIUS, dtype=torch.float32,
                    device="cpu")
    rng = np.random.default_rng(3)
    rand = lambda *s: torch.from_numpy(
        rng.standard_normal(s).astype(np.float32))
    # The symmetrization before the router's static sqrtg prescale.
    sym = tcov._pair_symmetrize(rand(2, 6, 4, n), rand(6, 4, n),
                                rand(6, 4, n), tcov._pair_sym_tables(tg))
    assert sym.shape == (6, 4, n)
    for link, back in tcov.edge_pairs():
        a = sym[link.face, tcov._SLOT[link.edge]] * tcov._OUT_SIGN[link.edge]
        b = sym[back.face, tcov._SLOT[back.edge]] * tcov._OUT_SIGN[back.edge]
        if link.reversed_:
            b = torch.flip(b, dims=[-1])
        assert torch.equal(a, -b)
