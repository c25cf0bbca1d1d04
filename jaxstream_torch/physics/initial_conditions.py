"""Initial conditions: the cosine bell (Williamson TC1), the checkerboard
heat source, Williamson TC2, TC5 and TC6, and the Galewsky jet.

Counterpart of :mod:`jaxstream.physics.initial_conditions`.  Fields are
evaluated analytically at extended cell centers (ghosts included) in
float64 numpy from the grid's stored coordinates, then cast to the grid
dtype on the grid's device — the same arithmetic as the JAX package, so
the results are bitwise equal.  Velocities are Cartesian 3-vectors
``(3, 6, M, M)`` tangent to the sphere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import EARTH_RADIUS
from ..geometry.cubed_sphere import CubedSphereGrid, _np_dtype

__all__ = ["solid_body_wind", "zonal_meridional_to_cartesian",
           "cosine_bell", "checkerboard", "williamson_tc2",
           "williamson_tc5", "williamson_tc6", "galewsky",
           "perturbed_ensemble", "EnsembleBasis"]


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy().astype(np.float64)


def _out(grid: CubedSphereGrid, arr: np.ndarray) -> torch.Tensor:
    arr = np.ascontiguousarray(arr.astype(_np_dtype(grid.dtype)))
    return torch.from_numpy(arr).to(grid.device)


def solid_body_wind(grid: CubedSphereGrid, u0: float, alpha_rot: float = 0.0):
    """Solid-body rotation wind W x r, axis tilted by ``alpha_rot``;
    ``(3, 6, M, M)`` in grid dtype, exact at every extended center."""
    xyz = _np(grid.xyz)
    w = (u0 / grid.radius) * np.array(
        [-np.sin(alpha_rot), 0.0, np.cos(alpha_rot)])
    v = np.stack([
        w[1] * xyz[2] - w[2] * xyz[1],
        w[2] * xyz[0] - w[0] * xyz[2],
        w[0] * xyz[1] - w[1] * xyz[0],
    ])
    return _out(grid, v)


def zonal_meridional_to_cartesian(grid: CubedSphereGrid, u, v):
    """(u zonal, v meridional) at extended centers -> Cartesian (3,6,M,M)."""
    lon = _np(grid.lon)
    lat = _np(grid.lat)
    e_lon = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)])
    e_lat = np.stack([
        -np.sin(lat) * np.cos(lon),
        -np.sin(lat) * np.sin(lon),
        np.cos(lat),
    ])
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    return _out(grid, u * e_lon + v * e_lat)


def _great_circle(grid: CubedSphereGrid, lon_c: float, lat_c: float):
    lon = _np(grid.lon)
    lat = _np(grid.lat)
    c = (np.sin(lat_c) * np.sin(lat)
         + np.cos(lat_c) * np.cos(lat) * np.cos(lon - lon_c))
    return grid.radius * np.arccos(np.clip(c, -1.0, 1.0))


def cosine_bell(grid: CubedSphereGrid, h0: float = 1000.0,
                lon_c: float = 3 * np.pi / 2, lat_c: float = 0.0,
                radius_frac: float = 1.0 / 3.0):
    """Williamson TC1's cosine bell: the extended scalar ``(6, M, M)``."""
    r = _great_circle(grid, lon_c, lat_c)
    R = radius_frac * grid.radius
    h = np.where(r < R, 0.5 * h0 * (1.0 + np.cos(np.pi * r / R)), 0.0)
    return _out(grid, h)


def checkerboard(grid: CubedSphereGrid, face: int = 4, lo: float = 1.0,
                 hi: float = 1000.0, tiles: int = 6):
    """A checkerboard heat source on one panel: alternating ``lo`` /
    ``hi`` blocks on ``face``, ``lo`` elsewhere; extended ``(6, M, M)``."""
    m = grid.m
    jj, ii = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    block = max(1, grid.n // tiles)
    pattern = np.where(((jj - grid.halo) // block
                        + (ii - grid.halo) // block) % 2 == 0, hi, lo)
    field = np.full((6, m, m), lo)
    field[face] = pattern
    return _out(grid, field)


def williamson_tc2(grid: CubedSphereGrid, gravity: float, omega: float,
                   u0: float = 2 * np.pi * EARTH_RADIUS / (12 * 86400),
                   gh0: float = 2.94e4, alpha_rot: float = 0.0):
    """TC2 steady geostrophic flow: ``(h_ext, v_ext)``."""
    lon = _np(grid.lon)
    lat = _np(grid.lat)
    a = grid.radius
    mu = (-np.cos(lon) * np.cos(lat) * np.sin(alpha_rot)
          + np.sin(lat) * np.cos(alpha_rot))
    gh = gh0 - (a * omega * u0 + 0.5 * u0 * u0) * mu * mu
    return _out(grid, gh / gravity), solid_body_wind(grid, u0, alpha_rot)


def williamson_tc5(grid: CubedSphereGrid, gravity: float, omega: float,
                   u0: float = 20.0, h0: float = 5960.0,
                   mountain_h: float = 2000.0, lon_c: float = 3 * np.pi / 2,
                   lat_c: float = np.pi / 6, mountain_r: float = np.pi / 9):
    """TC5 zonal flow over an isolated mountain: ``(h_ext, v_ext, b_ext)``
    with ``b`` the mountain height and ``h`` the fluid depth."""
    lon = _np(grid.lon)
    lat = _np(grid.lat)
    a = grid.radius
    gh = gravity * h0 - (a * omega * u0 + 0.5 * u0 * u0) * np.sin(lat) ** 2
    dlon = np.arctan2(np.sin(lon - lon_c), np.cos(lon - lon_c))
    r = np.sqrt(np.minimum(mountain_r**2, dlon**2 + (lat - lat_c) ** 2))
    b = mountain_h * (1.0 - r / mountain_r)
    h = gh / gravity - b
    return _out(grid, h), solid_body_wind(grid, u0, 0.0), _out(grid, b)


def williamson_tc6(grid: CubedSphereGrid, gravity: float, omega: float,
                   omega_w: float = 7.848e-6, k_w: float = 7.848e-6,
                   h0: float = 8000.0, r_w: int = 4):
    """TC6 Rossby-Haurwitz wave: ``(h_ext, v_ext)``."""
    lon = _np(grid.lon)
    th = _np(grid.lat)
    a = grid.radius
    R = r_w
    cos = np.cos(th)
    sin = np.sin(th)
    u = a * omega_w * cos + a * k_w * cos ** (R - 1) * (
        R * sin * sin - cos * cos) * np.cos(R * lon)
    v = -a * k_w * R * cos ** (R - 1) * sin * np.sin(R * lon)
    A = 0.5 * omega_w * (2 * omega + omega_w) * cos**2 \
        + 0.25 * k_w**2 * cos ** (2 * R) * (
            (R + 1) * cos**2 + (2 * R**2 - R - 2) - 2 * R**2 * cos ** (-2))
    B = (2 * (omega + omega_w) * k_w / ((R + 1) * (R + 2)) * cos**R
         * ((R**2 + 2 * R + 2) - (R + 1) ** 2 * cos**2))
    C = 0.25 * k_w**2 * cos ** (2 * R) * ((R + 1) * cos**2 - (R + 2))
    gh = gravity * h0 + a * a * (A + B * np.cos(R * lon)
                                 + C * np.cos(2 * R * lon))
    return _out(grid, gh / gravity), zonal_meridional_to_cartesian(grid, u, v)


def galewsky(grid: CubedSphereGrid, gravity: float, omega: float,
             u_max: float = 80.0, h_mean: float = 10158.0,
             lat0: float = np.pi / 7, lat1: float = np.pi / 2 - np.pi / 7,
             perturb: bool = True, h_hat: float = 120.0,
             alpha_p: float = 1.0 / 3.0, beta_p: float = 1.0 / 15.0,
             lat2: float = np.pi / 4):
    """Galewsky et al. (2004) barotropic-instability jet: ``(h_ext, v_ext)``.

    The balanced height is integrated numerically (fine trapezoid in
    float64) from ``gh'(lat) = -a u (f + u tan(lat) / a)``.
    """
    a = grid.radius
    en = np.exp(-4.0 / (lat1 - lat0) ** 2)

    def u_of(phi):
        inside = (phi > lat0) & (phi < lat1)
        safe = np.where(inside, (phi - lat0) * (phi - lat1), -1.0)
        return np.where(inside, u_max / en * np.exp(1.0 / safe), 0.0)

    # Fine latitude grid for the balance integral.
    phi_f = np.linspace(-np.pi / 2, np.pi / 2, 20001)
    u_f = u_of(phi_f)
    integrand = a * u_f * (2 * omega * np.sin(phi_f)
                           + u_f * np.tan(phi_f) / a)
    gh_f = -np.concatenate([[0.0], np.cumsum(
        0.5 * (integrand[1:] + integrand[:-1]) * np.diff(phi_f))])
    gh_f = gh_f - gh_f.mean() + gravity * h_mean

    lat = _np(grid.lat)
    lon = _np(grid.lon)
    h = np.interp(lat, phi_f, gh_f) / gravity
    if perturb:
        lonp = np.arctan2(np.sin(lon), np.cos(lon))  # wrap to (-pi, pi)
        h = h + h_hat * np.cos(lat) * np.exp(-((lonp / alpha_p) ** 2)) * \
            np.exp(-(((lat2 - lat) / beta_p) ** 2))
    u = u_of(lat)
    return _out(grid, h), zonal_meridional_to_cartesian(grid, u,
                                                        np.zeros_like(u))


def perturbed_ensemble(grid: CubedSphereGrid, h_ext, members: int,
                       seed: int = 0, amplitude: float = 1.0e-3):
    """Perturbed-IC height ensemble ``(B, 6, M, M)`` for batched runs.

    Member 0 is the unperturbed ``h_ext``; members ``1..B-1`` add
    ``amplitude * mean|h| * mode``, ``mode`` a random unit-normalized
    combination of three ``l = 1`` spherical modes ``ghat_j . rhat``,
    evaluated in float64 at the extended cell centres with numpy's
    ``default_rng(seed)``: the JAX package's recipe and draws, so a given
    ``(seed, members)`` gives its ensemble bitwise.  The wind is left
    unperturbed.
    """
    if members < 1:
        raise ValueError(f"members must be >= 1, got {members}")
    h = _np(h_ext) if isinstance(h_ext, torch.Tensor) else np.asarray(
        h_ext, np.float64)
    rhat = _np(grid.xyz) / grid.radius               # (3, 6, M, M)
    rng = np.random.default_rng(seed)
    href = float(np.mean(np.abs(h)))
    out = [h]
    for _ in range(members - 1):
        out.append(_perturbed(h, rhat, href, rng, amplitude))
    return _out(grid, np.stack(out))


def _perturbed(h, rhat, href, rng, amplitude):
    """One perturbed member: ``h + amplitude * href * mode`` with the next
    draws of ``rng`` (float64)."""
    g = rng.standard_normal((3, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    w = rng.standard_normal(3)
    mode = np.einsum("jk,k...->...", g * w[:, None], rhat)
    mode /= max(float(np.abs(mode).max()), 1e-300)
    return h + amplitude * href * mode


class EnsembleBasis:
    """What :func:`perturbed_ensemble` reads of one base height field,
    kept as host float64 arrays, for building members one at a time.

    The serving loop builds an incoming request's state while the device
    runs a segment; :func:`perturbed_ensemble` would read the grid's
    coordinates and the base field back from the device there, which
    waits for the segment.  :meth:`member` runs the same float64
    arithmetic on the kept arrays and puts the result on the grid's
    device with a non-blocking copy from pinned memory.
    """

    def __init__(self, grid: CubedSphereGrid, h_ext):
        self.grid = grid
        self.h = _np(h_ext)
        self.rhat = _np(grid.xyz) / grid.radius
        self.href = float(np.mean(np.abs(self.h)))

    def member(self, seed: int, amplitude: float) -> torch.Tensor:
        """Member 1 of ``perturbed_ensemble(grid, h_ext, 2, seed,
        amplitude)``, bitwise."""
        arr = _perturbed(self.h, self.rhat, self.href,
                         np.random.default_rng(seed), amplitude)
        t = torch.from_numpy(np.ascontiguousarray(
            arr.astype(_np_dtype(self.grid.dtype))))
        if self.grid.device.type != "cuda":
            return t.to(self.grid.device)
        return t.pin_memory().to(self.grid.device, non_blocking=True)
