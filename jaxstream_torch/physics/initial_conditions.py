"""Initial conditions: Williamson TC2 and TC5, and the Galewsky jet.

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
           "williamson_tc2", "williamson_tc5", "galewsky"]


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
