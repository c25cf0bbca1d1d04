"""Port parity: the analysis / visualization layer
(``jaxstream_torch.viz.plots``, queue A item 2).

The lat/lon index map is bitwise the JAX package's; ``to_latlon`` of a
tensor (gathered on its device) is bitwise its numpy form and the JAX
package's regrid of the same array; the plot functions take tensors or
arrays and write their figures (matplotlib, headless).
"""

import numpy as np
import pytest
import torch

import torch_single_thread  # noqa: F401  (one CPU thread per worker)

from jaxstream.viz import plots as jplots

from jaxstream_torch.viz import plots


@pytest.mark.parametrize("n, nlat, nlon", [(8, 19, 36), (24, 181, 360)])
def test_latlon_index_map_bitwise(n, nlat, nlon):
    for a, b in zip(jplots.latlon_index_map(n, nlat, nlon),
                    plots.latlon_index_map(n, nlat, nlon)):
        assert np.array_equal(a, b)


def test_to_latlon_tensor_numpy_and_jax_agree():
    rng = np.random.default_rng(8)
    ext = rng.standard_normal((2, 6, 12, 12))
    t = torch.from_numpy(ext)
    got = plots.to_latlon(t, 19, 36, halo=2)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 19, 36)
    want = plots.to_latlon(ext, 19, 36, halo=2)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jplots.to_latlon(ext, 19, 36, halo=2))


def test_plots_write_figures(tmp_path):
    import matplotlib.pyplot as plt

    f = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, 12, 12)))
    for fn, name in ((plots.plot_faces, "faces.png"),
                     (plots.plot_latlon, "latlon.png"),
                     (plots.plot_sphere, "sphere.png")):
        kw = {"nlat": 19, "nlon": 36} if fn is plots.plot_latlon else {}
        fig = fn(f, halo=2, title=name, path=str(tmp_path / name), **kw)
        assert (tmp_path / name).stat().st_size > 0
        plt.close(fig)
