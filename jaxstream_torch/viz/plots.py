"""Analysis / visualization layer (counterpart of :mod:`jaxstream.viz.plots`).

Per-face 6-panel plots, regridded lat/lon maps and 3-D sphere renders.
Regridding uses the exact inverse gnomonic map
(:func:`~jaxstream_torch.geometry.cubed_sphere.sphere_to_face_coords`)
with nearest-cell sampling, the index map precomputed once per (n, nlat,
nlon); :func:`to_latlon` gathers a tensor on its own device and a numpy
array on the host, the same cells either way.  Matplotlib (headless Agg)
is imported inside the plot functions only: the regridding needs numpy
and torch alone.  Every plot function returns the ``Figure`` and writes
``path`` if given.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..geometry.cubed_sphere import face_points, sphere_to_face_coords

__all__ = ["plot_faces", "latlon_index_map", "to_latlon", "plot_latlon",
           "plot_sphere"]

_FACE_TITLES = [
    "Face 0 (lon 0)", "Face 1 (lon 90E)", "Face 2 (lon 180)",
    "Face 3 (lon 270E)", "Face 4 (north)", "Face 5 (south)",
]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _interior(field, halo: int):
    """The interior of a field as a numpy array (a tensor is copied to
    the host)."""
    f = (field.detach().cpu().numpy() if isinstance(field, torch.Tensor)
         else np.asarray(field))
    if halo:
        f = f[..., halo:-halo, halo:-halo]
    return f


@functools.lru_cache(maxsize=8)
def latlon_index_map(n: int, nlat: int = 181, nlon: int = 360):
    """Nearest-cell ``(face, j, i)`` indices of a regular lat/lon grid
    into the interior ``(6, n, n)`` array (numpy, cached)."""
    lat = np.linspace(-90.0, 90.0, nlat) * np.pi / 180.0
    lon = np.linspace(0.0, 360.0, nlon, endpoint=False) * np.pi / 180.0
    LO, LA = np.meshgrid(lon, lat)
    p = np.stack(
        [np.cos(LA) * np.cos(LO), np.cos(LA) * np.sin(LO), np.sin(LA)],
        axis=-1,
    )
    face, alpha, beta = sphere_to_face_coords(p)
    d = (np.pi / 2) / n
    i = np.clip(((alpha + np.pi / 4) / d - 0.5).round().astype(int), 0, n - 1)
    j = np.clip(((beta + np.pi / 4) / d - 0.5).round().astype(int), 0, n - 1)
    return face, j, i


def to_latlon(field, nlat: int = 181, nlon: int = 360, halo: int = 0):
    """Regrid an interior ``(..., 6, n, n)`` field to ``(..., nlat,
    nlon)``: a tensor on its device (one gather), an array in numpy."""
    if isinstance(field, torch.Tensor):
        f = field[..., halo:-halo, halo:-halo] if halo else field
        n = f.shape[-1]
        idx = [torch.from_numpy(a).to(f.device)
               for a in latlon_index_map(n, nlat, nlon)]
        return f[(Ellipsis, *idx)]
    f = _interior(field, halo)
    face, j, i = latlon_index_map(f.shape[-1], nlat, nlon)
    return f[..., face, j, i]


def plot_faces(field, halo: int = 0, title: str = "", units: str = "",
               cmap: str = "viridis", path: Optional[str] = None):
    """2x3 grid of the 6 faces with a shared colorbar; ``field`` (6, ny,
    nx) (``halo`` strips the ghosts of an extended field)."""
    plt = _pyplot()
    f = _interior(field, halo)
    vmin, vmax = float(np.nanmin(f)), float(np.nanmax(f))
    fig, axes = plt.subplots(2, 3, figsize=(11, 6.5), constrained_layout=True)
    for k, ax in enumerate(axes.flat):
        im = ax.pcolormesh(f[k], cmap=cmap, vmin=vmin, vmax=vmax)
        ax.set_title(_FACE_TITLES[k], fontsize=9)
        ax.set_aspect("equal")
        ax.set_xticks([])
        ax.set_yticks([])
    cb = fig.colorbar(im, ax=axes, shrink=0.85)
    if units:
        cb.set_label(units)
    if title:
        fig.suptitle(title)
    if path:
        fig.savefig(path, dpi=130)
    return fig


def plot_latlon(field, halo: int = 0, title: str = "", units: str = "",
                cmap: str = "viridis", nlat: int = 181, nlon: int = 360,
                path: Optional[str] = None):
    """Global lat/lon map of a field, regridded by :func:`to_latlon`."""
    plt = _pyplot()
    ll = to_latlon(_interior(field, halo), nlat, nlon)
    fig, ax = plt.subplots(figsize=(10, 5), constrained_layout=True)
    im = ax.pcolormesh(
        np.linspace(0, 360, ll.shape[-1], endpoint=False),
        np.linspace(-90, 90, ll.shape[-2]),
        ll, cmap=cmap,
    )
    ax.set_xlabel("longitude")
    ax.set_ylabel("latitude")
    cb = fig.colorbar(im, ax=ax, shrink=0.9)
    if units:
        cb.set_label(units)
    if title:
        ax.set_title(title)
    if path:
        fig.savefig(path, dpi=130)
    return fig


def plot_sphere(field, halo: int = 0, title: str = "", cmap: str = "viridis",
                elev: float = 20.0, azim: float = -60.0,
                path: Optional[str] = None):
    """3-D sphere render of all 6 faces."""
    plt = _pyplot()
    f = _interior(field, halo)
    n = f.shape[-1]
    d = (np.pi / 2) / n
    edges = -np.pi / 4 + np.arange(n + 1) * d
    norm = plt.Normalize(float(np.nanmin(f)), float(np.nanmax(f)))
    cm = plt.get_cmap(cmap)
    fig = plt.figure(figsize=(7, 7), constrained_layout=True)
    ax = fig.add_subplot(projection="3d")
    for k in range(6):
        bb, aa = np.meshgrid(edges, edges, indexing="ij")
        p = face_points(k, aa, bb)  # (n+1, n+1, 3) cell-corner points
        ax.plot_surface(
            p[..., 0], p[..., 1], p[..., 2],
            facecolors=cm(norm(f[k])), rstride=1, cstride=1,
            shade=False, antialiased=False, linewidth=0,
        )
    ax.set_box_aspect((1, 1, 1))
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.colorbar(plt.cm.ScalarMappable(norm=norm, cmap=cm), ax=ax,
                 shrink=0.7)
    if title:
        ax.set_title(title)
    if path:
        fig.savefig(path, dpi=130)
    return fig
